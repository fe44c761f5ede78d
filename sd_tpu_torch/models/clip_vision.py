"""CLIP vision tower, the safety checker's image encoder (port of
``sd_tpu/models/clip_vision.py``).

A ViT: a patchifying conv without bias, a class token, position
embeddings, pre-LayerNorm, pre-LN encoder layers (the text tower's
``CLIPEncoderLayer``, unmasked, so on the card their self-attention takes
the K1 kernel) and post-LayerNorm of the class token. Parameter names are
HF's ``CLIPVisionModel`` ones (``vision_model.embeddings.patch_embedding.weight``,
``vision_model.encoder.layers.{i}.self_attn.q_proj`` ...), so a ported
``state_dict`` loads as it is; the projection to the shared embedding space
(``visual_projection``) is its user's, as in HF's safety checker.

:func:`clip_image_preprocess` is ``sd_tpu``'s ``jax.image.resize(...,
"bicubic", antialias=True)`` to 224² (``ops/resize.py``: two weight
matrices built on the host in float64 with JAX's scale-and-translate rule,
two matrix products on the device) and CLIP's normalisation.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from sd_tpu_torch.models.clip import CLIPEncoderLayer, CLIPTextConfig
from sd_tpu_torch.ops.norms import LayerNormFp32
from sd_tpu_torch.ops.resize import resize

__all__ = ["CLIPVisionConfig", "CLIPVisionModel", "CLIP_VIT_L_14_VISION",
           "clip_image_preprocess"]


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    projection_dim: int = 768


# openai/clip-vit-large-patch14's vision tower, the safety checker's
CLIP_VIT_L_14_VISION = CLIPVisionConfig()

_MEAN = (0.48145466, 0.4578275, 0.40821073)
_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_image_preprocess(x: torch.Tensor) -> torch.Tensor:
    """Images ``[B, H, W, 3]`` in [-1, 1] (any size) → ``[B, 3, 224, 224]``
    float32, resized and CLIP-normalised."""
    x = resize(((x.float() + 1.0) / 2.0).permute(0, 3, 1, 2), (224, 224), "bicubic")
    mean = torch.tensor(_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


class CLIPVisionTransformer(nn.Module):
    """HF's ``vision_model``: embeddings, pre-LN, encoder, post-LN."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.embeddings = nn.Module()
        self.embeddings.class_embedding = nn.Parameter(torch.empty(d))
        self.embeddings.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, stride=cfg.patch_size,
                                                    bias=False)
        self.embeddings.position_embedding = nn.Embedding(n_pos, d)
        self.pre_layrnorm = LayerNormFp32(d)
        layer_cfg = CLIPTextConfig(hidden_size=d, intermediate_size=cfg.intermediate_size,
                                   num_attention_heads=cfg.num_attention_heads)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(CLIPEncoderLayer(layer_cfg)
                                            for _ in range(cfg.num_hidden_layers))
        self.post_layernorm = LayerNormFp32(d)

    def forward(self, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        emb = self.embeddings
        w = emb.patch_embedding.weight
        x = emb.patch_embedding(pixel_values.to(w.dtype)).flatten(2).transpose(1, 2)
        cls = emb.class_embedding.to(x.dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight[None].to(x.dtype)
        x = self.pre_layrnorm(x)
        for layer in self.encoder.layers:
            x = layer(x, None)
        return {"last_hidden_state": x, "pooler_output": self.post_layernorm(x[:, 0])}


class CLIPVisionModel(nn.Module):
    """``forward(pixel_values [B, 3, S, S])`` → ``last_hidden_state`` and
    ``pooler_output`` (the post-LayerNorm class token)."""

    def __init__(self, cfg: CLIPVisionConfig = CLIP_VIT_L_14_VISION):
        super().__init__()
        self.config = cfg
        self.vision_model = CLIPVisionTransformer(cfg)

    def forward(self, pixel_values: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.vision_model(pixel_values)
