"""NSFW safety checker (port of ``sd_tpu/pipelines/safety.py``), the HF
``StableDiffusionSafetyChecker`` that the reference's txt2img applies.

A CLIP-vision image embedding, its cosine similarity against 17 "concept"
embeddings with per-concept thresholds, and 3 special-care concepts that
tighten the margin by 0.01 where any of them fires; an image is flagged
where any concept's score is above 0. Flagged images are replaced by
:func:`placeholder_image`. The module's ``state_dict`` is the HF checker's
(``vision_model.vision_model.*``, ``visual_projection.weight``,
``concept_embeds``, ``concept_embeds_weights``, ``special_care_embeds``,
``special_care_embeds_weights``), so :func:`port_safety_checker` is a plain
``load_state_dict``. Without trained weights :meth:`SafetyChecker.untrained`
scores every image with a small random tower and thresholds no cosine can
pass: the work runs, nothing is flagged.

Scores are computed on the device from the decoded uint8 batch, before the
images are fetched.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sd_tpu_torch.models.clip_vision import (
    CLIP_VIT_L_14_VISION,
    CLIPVisionConfig,
    CLIPVisionModel,
    clip_image_preprocess,
)

__all__ = ["SafetyChecker", "port_safety_checker", "placeholder_image", "replace_flagged",
           "UNTRAINED_CONFIG"]

# the tower SafetyChecker.random_init and .untrained draw: 7x7 patches of 32
# (50 tokens), width 64, 2 layers of 4 heads
UNTRAINED_CONFIG = CLIPVisionConfig(image_size=224, patch_size=32, hidden_size=64,
                                    intermediate_size=128, num_hidden_layers=2,
                                    num_attention_heads=4, projection_dim=16)


def placeholder_image(h: int, w: int) -> np.ndarray:
    """The neutral replacement image: gray with stripes 16 rows high."""
    img = np.full((h, w, 3), 64, np.uint8)
    img[(np.arange(h) // 16) % 2 == 0] = 96
    return img


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
    b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
    return a @ b.t()


class SafetyChecker(nn.Module):
    """``nsfw_scores(images)`` → flags ``[B]`` on the images' device;
    ``forward(images_u8)`` → ``(checked host images, flags)``."""

    def __init__(self, config: CLIPVisionConfig = CLIP_VIT_L_14_VISION):
        super().__init__()
        self.config = config
        d = config.projection_dim
        self.vision_model = CLIPVisionModel(config)
        self.visual_projection = nn.Linear(config.hidden_size, d, bias=False)
        self.concept_embeds = nn.Parameter(torch.empty(17, d))
        self.special_care_embeds = nn.Parameter(torch.empty(3, d))
        self.concept_embeds_weights = nn.Parameter(torch.empty(17))
        self.special_care_embeds_weights = nn.Parameter(torch.empty(3))

    @classmethod
    @torch.no_grad()
    def random_init(cls, seed: int = 0, config: Optional[CLIPVisionConfig] = None
                    ) -> "SafetyChecker":
        """Random weights from a CPU ``torch.Generator`` seeded ``seed`` (so
        every device gets the same checker), thresholds 0.99."""
        from sd_tpu_torch.utils.config import init_random_

        checker = cls(config or UNTRAINED_CONFIG)
        init_random_(checker, torch.Generator().manual_seed(seed))
        checker.concept_embeds_weights.fill_(0.99)
        checker.special_care_embeds_weights.fill_(0.99)
        return checker.eval()

    @classmethod
    @torch.no_grad()
    def untrained(cls, seed: int = 0, config: Optional[CLIPVisionConfig] = None
                  ) -> "SafetyChecker":
        """:meth:`random_init` with thresholds of 2.0, which no cosine
        reaches: the scoring runs, nothing is flagged."""
        checker = cls.random_init(seed, config)
        checker.concept_embeds_weights.fill_(2.0)
        checker.special_care_embeds_weights.fill_(2.0)
        return checker

    @torch.inference_mode()
    def image_embeds(self, images: torch.Tensor) -> torch.Tensor:
        """Images ``[B, H, W, 3]`` (uint8, or float in [0, 1]) → the
        projected CLIP embeddings ``[B, projection_dim]`` in float32."""
        x = images.float()
        if images.dtype == torch.uint8:
            x = x / 255.0
        pooled = self.vision_model(clip_image_preprocess(x * 2.0 - 1.0))["pooler_output"]
        return self.visual_projection(pooled.to(self.visual_projection.weight.dtype)).float()

    @torch.inference_mode()
    def nsfw_scores(self, images: torch.Tensor) -> torch.Tensor:
        """Flags ``[B]`` (bool, on the images' device)."""
        emb = self.image_embeds(images)
        special = _cosine(emb, self.special_care_embeds.float()) \
            - self.special_care_embeds_weights.float()
        adj = torch.where((special > 0).any(dim=1), 0.01, 0.0)[:, None]
        concept = _cosine(emb, self.concept_embeds.float()) \
            - self.concept_embeds_weights.float() + adj
        return (concept > 0).any(dim=1)

    def forward(self, images_u8) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 ``[B, H, W, 3]`` (host or device) → ``(checked images,
        flags)`` on the host; flagged images are replaced."""
        device = self.concept_embeds.device
        images = torch.as_tensor(images_u8).to(device)
        flags = self.nsfw_scores(images).cpu().numpy()
        return replace_flagged(images.cpu().numpy(), flags), flags


def replace_flagged(images_u8: np.ndarray, flags: np.ndarray) -> np.ndarray:
    """The host batch with each flagged image replaced by the placeholder."""
    if not flags.any():
        return images_u8
    out = images_u8.copy()
    for i, bad in enumerate(flags):
        if bad:
            out[i] = placeholder_image(*out.shape[1:3])
    return out


def port_safety_checker(sd: Mapping[str, torch.Tensor],
                        config: CLIPVisionConfig = CLIP_VIT_L_14_VISION) -> SafetyChecker:
    """A checker holding an HF ``StableDiffusionSafetyChecker`` ``state_dict``
    (its vision tower ``config``; ViT-L/14 by default), on the CPU in
    float32. HF's ``position_ids`` buffers are dropped."""
    checker = SafetyChecker(config)
    checker.load_state_dict({k: v for k, v in sd.items() if not k.endswith("position_ids")})
    return checker.float().eval()
