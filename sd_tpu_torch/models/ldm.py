"""LatentDiffusion: the UNet, the first stage and the cond stage in one
module (port of ``sd_tpu/models/ldm.py``).

Submodule names follow the reference checkpoints: ``model.diffusion_model.*``
(the UNet), ``first_stage_model.*`` (the KL autoencoder: ``encoder``,
``quant_conv``, ``post_quant_conv``, ``decoder``; the VQ model, with
``quantize.embedding``; or the parameterless ``IdentityFirstStage`` of
pixel-space diffusion) and ``cond_stage_model.*`` (CLIP's
``transformer.text_model.*``, a ``ClassEmbedder``'s ``embedding``, a
``BERTEmbedder``'s ``transformer.*``; the first stage itself with
``__is_first_stage__``, whose weights the ``state_dict`` then holds under
both names, as the reference's does; nothing for an unconditional model), so
the module's ``state_dict`` keys are the checkpoint's keys. The cond stage
reads the batch entry named by ``cond_stage_key``. ``scale_factor`` is a
float that the trainer's ``scale_by_std`` calibration sets and checkpoint
metadata carries, as ``sd_tpu`` carries it.

:meth:`LatentDiffusion.apply_model` is ``sd_tpu``'s conditioning dispatch
(``conditioning_key`` None, ``concat``, ``crossattn``, ``hybrid`` or
``adm``): ``cond`` is None, a tensor for the key's entry, or a dict of
``c_concat`` (channels concatenated to x), ``c_crossattn`` (the context;
lists concatenated over tokens) and ``y`` (class ids). A VQ first stage
encodes to its latent before quantization and decodes through the codebook
unless ``force_not_quantize`` (the reference's flag; ``sd_tpu`` passes its
own inverted).

Images are NCHW here; the batch contract at the trainer is ``sd_tpu``'s
NHWC.

:meth:`LatentDiffusion.set_int8_mode` holds the int8 serving mode on the
UNet's and the first stage's sites and quantizes their weights at once,
the counterpart of ``sd_tpu``'s ``unet_qw``/``first_stage_qw`` overlays;
each site quantizes again if its weights are replaced later, so no stale
int8 weights are served. :meth:`LatentDiffusion.set_conv_modes` holds the
two conv modes of ``sd_tpu`` on the sites: ``SD_TPU_FUSED_CONV`` on every
``ResBlock`` and ``VAEResnetBlock`` (``conv_impl``, K7) and
``SD_TPU_CONV_IMPL`` on every ``Conv3x3`` (``impl``, K8).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from sd_tpu_torch.core.distributions import DiagonalGaussian
from sd_tpu_torch.core.schedules import DiffusionSchedule, q_sample
from sd_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from sd_tpu_torch.models.unet import UNetModel
from sd_tpu_torch.models.vae import VQModel
from sd_tpu_torch.ops import quant
from sd_tpu_torch.ops.resblock import set_conv_modes

__all__ = ["LatentDiffusion", "FrozenCLIPEmbedder", "DiffusionWrapper", "CONDITIONING_KEYS"]

# conditioning_key -> the cond dict's entry that a bare tensor stands for
CONDITIONING_KEYS = {"concat": "c_concat", "crossattn": "c_crossattn", "adm": "y"}


def _cond_entry(cond: Dict[str, Any], name: str) -> Optional[torch.Tensor]:
    """One entry of a cond dict; a list is concatenated as the reference's
    ``DiffusionWrapper`` does (channels for ``c_concat``, tokens for
    ``c_crossattn``), and ``y``'s list gives its first element."""
    v = cond.get(name)
    if isinstance(v, (list, tuple)):
        v = v[0] if name == "y" else torch.cat(list(v), dim=1)
    return v


class DiffusionWrapper(nn.Module):
    def __init__(self, unet: UNetModel):
        super().__init__()
        self.diffusion_model = unet


class FrozenCLIPEmbedder(nn.Module):
    """The CLIP text tower as SD holds it (``transformer``)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.transformer = CLIPTextModel(cfg)

    def encode(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.transformer.encode(input_ids)


class LatentDiffusion(nn.Module):
    def __init__(self, unet: UNetModel, first_stage: nn.Module,
                 cond_stage: Optional[nn.Module], schedule: DiffusionSchedule,
                 scale_factor: float = 1.0, parameterization: str = "eps",
                 cond_stage_key: str = "caption",
                 conditioning_key: Optional[str] = "crossattn"):
        super().__init__()
        if conditioning_key not in (None, "concat", "crossattn", "hybrid", "adm"):
            raise ValueError(f"conditioning_key {conditioning_key!r}")
        self.model = DiffusionWrapper(unet)
        self.first_stage_model = first_stage
        self.cond_stage_model = cond_stage
        self.conditioning_key = conditioning_key
        self.schedule = schedule
        self.scale_factor = scale_factor
        self.parameterization = parameterization
        # the batch entry that feeds the cond stage (token ids)
        self.cond_stage_key = cond_stage_key
        # the int8 serving mode held on the sites (set_int8_mode)
        self.int8_mode = quant.INT8_OFF
        # the conv modes held on the sites (set_conv_modes)
        self.fused_conv, self.conv_impl = "auto", "auto"

    def set_conv_modes(self, fused_conv=None, conv_impl=None):
        """Hold the fused conv mode (``SD_TPU_FUSED_CONV``'s values) on every
        resnet block and the conv mode (``SD_TPU_CONV_IMPL``'s) on every
        ``Conv3x3``; None reads the variable. Returns both, parsed."""
        self.fused_conv, self.conv_impl = set_conv_modes(self, fused_conv, conv_impl)
        return self.fused_conv, self.conv_impl

    def set_int8_mode(self, mode) -> quant.Int8Mode:
        """Hold the int8 serving ``mode`` (``SD_TPU_INT8``'s grammar or a
        ``quant.Int8Mode``) on every site, and quantize the weights it reads
        now where it will run (bf16 on the card); returns the mode."""
        mode = self.int8_mode = quant.set_int8_mode(self, mode)
        probe = next(self.parameters())
        if any(quant.int8_bucket_enabled(mode, b, probe) for b in ("conv", "ff", "proj")):
            quant.prequantize_weights(self)
        return mode

    def apply_model(self, x: torch.Tensor, t: torch.Tensor, cond=None) -> torch.Tensor:
        """eps prediction for latents ``x [B, C, h, w]`` at timesteps ``t [B]``
        under ``cond`` (see the module's docstring)."""
        key = self.conditioning_key
        if cond is not None and not isinstance(cond, dict):
            cond = {CONDITIONING_KEYS.get(key, "c_crossattn"): cond}
        cond = cond or {}
        unet = self.model.diffusion_model
        if key is None:
            return unet(x, t)
        if key == "crossattn":
            return unet(x, t, context=_cond_entry(cond, "c_crossattn"))
        if key == "adm":
            return unet(x, t, y=_cond_entry(cond, "y"))
        xc = torch.cat([x, _cond_entry(cond, "c_concat").to(x.dtype)], dim=1)
        if key == "concat":
            return unet(xc, t)
        return unet(xc, t, context=_cond_entry(cond, "c_crossattn"))

    @property
    def cond_stage_is_first_stage(self) -> bool:
        return self.cond_stage_model is self.first_stage_model

    def encode_first_stage(self, x: torch.Tensor):
        """Images ``[B, 3, H, W]`` in [-1, 1] → the unscaled latent posterior
        (a VQ model's latent before quantization; the images themselves
        through an ``IdentityFirstStage``)."""
        if isinstance(self.first_stage_model, VQModel):
            return self.first_stage_model.encode_pre_quant(x)
        return self.first_stage_model.encode(x)

    def get_first_stage_encoding(self, encoding,
                                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """A posterior sample drawn from ``generator`` (the mode without
        one), or a VQ or identity stage's latent, times ``scale_factor``."""
        if isinstance(encoding, DiagonalGaussian):
            encoding = encoding.mode() if generator is None else encoding.sample(generator)
        return self.scale_factor * encoding

    def encode_to_latent(self, x: torch.Tensor,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.get_first_stage_encoding(self.encode_first_stage(x), generator)

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        return q_sample(self.schedule, x_start, t, noise)

    def decode_first_stage(self, z: torch.Tensor, force_not_quantize: bool = False
                           ) -> torch.Tensor:
        """Latents → images in [-1, 1] (``1 / scale_factor``, then decode; a
        VQ stage quantizes first unless ``force_not_quantize``)."""
        z = z / self.scale_factor
        if isinstance(self.first_stage_model, VQModel):
            return self.first_stage_model.decode(z, force_not_quantize=force_not_quantize)
        return self.first_stage_model.decode(z)

    def get_learned_conditioning(self, c):
        """The cond stage's conditioning for ``c``: token ids or class ids
        through its encoder; images through the first stage where it is the
        cond stage (unscaled, a posterior's mode); ``c`` itself for an
        unconditional model."""
        if self.cond_stage_model is None:
            return c
        if self.cond_stage_is_first_stage:
            encoding = self.encode_first_stage(c)
            return encoding.mode() if isinstance(encoding, DiagonalGaussian) else encoding
        return self.cond_stage_model.encode(c)
