"""LatentDiffusion: the UNet, the first stage and the text encoder in one
module (port of ``sd_tpu/models/ldm.py``, ``crossattn`` conditioning only).

Submodule names follow the SD checkpoint: ``model.diffusion_model.*`` (the
UNet), ``first_stage_model.*`` (the KL decoder half) and
``cond_stage_model.transformer.text_model.*`` (CLIP), so the module's
``state_dict`` keys are the checkpoint's keys.
"""

from __future__ import annotations

import torch
from torch import nn

from sd_tpu_torch.core.schedules import DiffusionSchedule
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
                 scale_factor: float = 1.0):
        super().__init__()
        self.model = DiffusionWrapper(unet_config)
        self.first_stage_model = AutoencoderKL(ddconfig, embed_dim)
        self.cond_stage_model = FrozenCLIPEmbedder(clip_config)
        self.schedule = schedule
        self.scale_factor = scale_factor

    def apply_model(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """eps prediction for latents ``x [B, C, h, w]`` at timesteps ``t [B]``."""
        return self.model.diffusion_model(x, t, context=cond)

    def decode_first_stage(self, z: torch.Tensor) -> torch.Tensor:
        """Latents → images in [-1, 1] (``1 / scale_factor``, then decode)."""
        return self.first_stage_model.decode(z / self.scale_factor)

    def get_learned_conditioning(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.cond_stage_model.encode(input_ids)
