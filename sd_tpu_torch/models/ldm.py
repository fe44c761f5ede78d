"""LatentDiffusion: the UNet, the first stage and the text encoder in one
module (port of ``sd_tpu/models/ldm.py``, ``crossattn`` conditioning only).

Submodule names follow the SD checkpoint: ``model.diffusion_model.*`` (the
UNet), ``first_stage_model.*`` (the KL autoencoder: ``encoder``,
``quant_conv``, ``post_quant_conv``, ``decoder``) and
``cond_stage_model.transformer.text_model.*`` (CLIP), so the module's
``state_dict`` keys are the checkpoint's keys.

Images are NCHW here; the batch contract at the trainer is ``sd_tpu``'s
NHWC.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sd_tpu_torch.core.distributions import DiagonalGaussian
from sd_tpu_torch.core.schedules import DiffusionSchedule, q_sample
from sd_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from sd_tpu_torch.models.unet import UNetConfig, UNetModel
from sd_tpu_torch.models.vae import AutoencoderKL

__all__ = ["LatentDiffusion", "FrozenCLIPEmbedder", "DiffusionWrapper"]


class DiffusionWrapper(nn.Module):
    def __init__(self, unet_config: UNetConfig):
        super().__init__()
        self.diffusion_model = UNetModel(unet_config)


class FrozenCLIPEmbedder(nn.Module):
    """The CLIP text tower as SD holds it (``transformer``)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.transformer = CLIPTextModel(cfg)

    def encode(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.transformer.encode(input_ids)


class LatentDiffusion(nn.Module):
    def __init__(self, unet_config: UNetConfig, ddconfig: dict, embed_dim: int,
                 clip_config: CLIPTextConfig, schedule: DiffusionSchedule,
                 scale_factor: float = 1.0, parameterization: str = "eps",
                 cond_stage_key: str = "caption"):
        super().__init__()
        self.model = DiffusionWrapper(unet_config)
        self.first_stage_model = AutoencoderKL(ddconfig, embed_dim)
        self.cond_stage_model = FrozenCLIPEmbedder(clip_config)
        self.schedule = schedule
        self.scale_factor = scale_factor
        self.parameterization = parameterization
        # the batch entry that feeds the cond stage (token ids)
        self.cond_stage_key = cond_stage_key

    def apply_model(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """eps prediction for latents ``x [B, C, h, w]`` at timesteps ``t [B]``."""
        return self.model.diffusion_model(x, t, context=cond)

    def encode_first_stage(self, x: torch.Tensor) -> DiagonalGaussian:
        """Images ``[B, 3, H, W]`` in [-1, 1] → the unscaled latent posterior."""
        return self.first_stage_model.encode(x)

    def get_first_stage_encoding(self, encoding: DiagonalGaussian,
                                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A posterior sample drawn from ``generator`` (the mode without
        one), times ``scale_factor``."""
        z = encoding.mode() if generator is None else encoding.sample(generator)
        return self.scale_factor * z

    def encode_to_latent(self, x: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.get_first_stage_encoding(self.encode_first_stage(x), generator)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        return q_sample(self.schedule, x_start, t, noise)

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """Latents → images in [-1, 1] (``1 / scale_factor``, then decode)."""
        return self.first_stage_model.decode(z / self.scale_factor)

    def get_learned_conditioning(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.cond_stage_model.encode(input_ids)
