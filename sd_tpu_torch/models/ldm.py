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

``split_input_params`` (None, or the reference's dict: ``ks``, ``stride``,
``vqf``, ``patch_distributed_vq``, ``clip_min_weight``/``clip_max_weight``,
``original_image_size``; set on the model, as the reference's notebook sets
it) tiles the model over a large canvas (``pipelines/tiled.py``), as
``sd_tpu`` does: :meth:`LatentDiffusion.apply_model` runs the ``ks x ks``
latent patches (``ks`` clamped to the smaller side) as one batched UNet
call, spatial conds (``c_concat``, or a map under ``cond_stage_key``
``image``/``LR_image``/``segmentation``/``bbox_img``) tiled on x's grid,
context and ``y`` repeated per patch, and with ``coordinates_bbox`` each
patch's layout re-tokenized with its crop's code by ``bbox_tokenizer``
(``data/layout.py``); with ``patch_distributed_vq`` the first stage encodes
and decodes patch by patch too (image patches of ``ks``, latent patches of
``ks / vqf``).

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

import numpy as np
import torch
from torch import nn

from sd_tpu_torch.core.distributions import DiagonalGaussian
from sd_tpu_torch.core.schedules import DiffusionSchedule, q_sample
from sd_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from sd_tpu_torch.models.unet import UNetModel
from sd_tpu_torch.models.vae import IdentityFirstStage, VQModel
from sd_tpu_torch.ops import quant
from sd_tpu_torch.ops.resblock import set_conv_modes
from sd_tpu_torch.pipelines.tiled import extract_patches, fold_patches, tiled_apply

__all__ = ["LatentDiffusion", "FrozenCLIPEmbedder", "DiffusionWrapper", "CONDITIONING_KEYS"]

# conditioning_key -> the cond dict's entry that a bare tensor stands for
CONDITIONING_KEYS = {"concat": "c_concat", "crossattn": "c_crossattn", "adm": "y"}
# the cond_stage_keys whose conditioning is a map tiled on x's patch grid
SPATIAL_COND_KEYS = ("image", "LR_image", "segmentation", "bbox_img")


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
        # tiling over a large canvas (see the module's docstring), and the
        # layout tokenizer of its coordinates_bbox route
        self.split_input_params: Optional[Dict[str, Any]] = None
        self.bbox_tokenizer = None

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
        under ``cond`` (see the module's docstring); tiled where
        ``split_input_params`` is set."""
        if self.split_input_params is not None:
            return self._apply_model_tiled(x, t, cond)
        return self._apply_model_inner(x, t, cond)

    def _split(self, name: str, default: int) -> int:
        v = self.split_input_params.get(name, default)
        return v[0] if isinstance(v, (tuple, list)) else v

    def _fold_weights(self) -> Dict[str, float]:
        p = self.split_input_params
        return dict(clip_min=p.get("clip_min_weight", 0.01),
                    clip_max=p.get("clip_max_weight", 0.5))

    def _apply_model_tiled(self, x: torch.Tensor, t: torch.Tensor, cond) -> torch.Tensor:
        """The UNet over ``ks x ks`` patches of x in one batched call,
        stitched; ``sd_tpu``'s ``_apply_model_tiled``."""
        ks = min(self._split("ks", 128), x.shape[2], x.shape[3])
        stride = self._split("stride", 64)
        b, _, h, w = x.shape
        x_p, sy, sx = extract_patches(x, ks, stride)
        n = x_p.shape[1]
        flat = x_p.reshape((b * n,) + x_p.shape[2:])
        if cond is not None and not isinstance(cond, dict):
            cond = {CONDITIONING_KEYS.get(self.conditioning_key, "c_crossattn"): cond}
        cond_flat = None
        if cond:
            if self.cond_stage_key == "coordinates_bbox":
                ids = _cond_entry(cond, "c_crossattn")
                cond_flat = {"c_crossattn": self._bbox_patch_conditioning(ids, sy, sx, ks)}
            else:
                cond_flat = {}
                for name in cond:
                    v = _cond_entry(cond, name)
                    spatial = name == "c_concat" or (
                        v.ndim == 4 and tuple(v.shape[2:]) == (h, w)
                        and self.cond_stage_key in SPATIAL_COND_KEYS)
                    if name != "y" and spatial:
                        v_p = extract_patches(v, ks, stride)[0]
                        cond_flat[name] = v_p.reshape((b * n,) + v_p.shape[2:])
                    else:
                        cond_flat[name] = v.repeat_interleave(n, dim=0)
        out = self._apply_model_inner(flat, t.repeat_interleave(n, dim=0), cond_flat)
        return fold_patches(out.reshape((b, n) + out.shape[1:]), (h, w), ks, sy, sx,
                            **self._fold_weights())

    def _bbox_patch_conditioning(self, ids: torch.Tensor, sy, sx, ks: int) -> torch.Tensor:
        """Each patch's context: the layout ids ``[B, n]`` with their last two
        tokens replaced by the patch's crop code (``bbox_tokenizer``'s
        ``crop_encoder`` of its top-left corner and size, in units of the
        original image), re-encoded by the cond stage; ``[B·P, n, C]``,
        batch-major."""
        if self.bbox_tokenizer is None:
            raise ValueError("coordinates_bbox tiling needs ldm.bbox_tokenizer")
        p = self.split_input_params
        if "original_image_size" not in p:
            raise ValueError("coordinates_bbox tiling needs split_input_params' "
                             "original_image_size")
        full_h, full_w = p["original_image_size"]
        encoder = getattr(self.first_stage_model, "encoder", None)
        rescale = p.get("vqf", 4 if encoder is None else 2 ** (len(encoder.down) - 1))
        crops = np.stack([self.bbox_tokenizer.crop_encoder(
            (rescale * xx / full_w, rescale * y / full_h, rescale * ks / full_w,
             rescale * ks / full_h)) for y in sy for xx in sx])
        crops = torch.from_numpy(crops).to(ids.device, ids.dtype)
        b, n = ids.shape[0], crops.shape[0]
        adapted = torch.cat([ids[:, :-2].repeat_interleave(n, dim=0), crops.repeat(b, 1)], dim=1)
        return self.get_learned_conditioning(adapted)

    def _apply_model_inner(self, x: torch.Tensor, t: torch.Tensor, cond=None) -> torch.Tensor:
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

    def _patch_distributed(self) -> bool:
        p = self.split_input_params
        return (p is not None and bool(p.get("patch_distributed_vq"))
                and not isinstance(self.first_stage_model, IdentityFirstStage))

    def encode_first_stage(self, x: torch.Tensor):
        """Images ``[B, 3, H, W]`` in [-1, 1] → the unscaled latent posterior
        (a VQ model's latent before quantization; the images themselves
        through an ``IdentityFirstStage``); patch by patch with
        ``patch_distributed_vq`` (a KL posterior's moments stitched)."""
        m = self.first_stage_model
        if not self._patch_distributed():
            return m.encode_pre_quant(x) if isinstance(m, VQModel) else m.encode(x)
        vqf = self.split_input_params.get("vqf", 4)

        def encode(patches):
            if isinstance(m, VQModel):
                return m.encode_pre_quant(patches)
            posterior = m.encode(patches)
            return torch.cat([posterior.mean, posterior.logvar], dim=1)

        out = tiled_apply(encode, x, ks=min(self._split("ks", 128), x.shape[2]),
                          stride=self._split("stride", 64), out_scale=1.0 / vqf,
                          **self._fold_weights())
        return out if isinstance(m, VQModel) else DiagonalGaussian.from_moments(out)

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
        VQ stage quantizes first unless ``force_not_quantize``); patch by
        patch with ``patch_distributed_vq``."""
        z = z / self.scale_factor
        m = self.first_stage_model

        def decode(latents):
            if isinstance(m, VQModel):
                return m.decode(latents, force_not_quantize=force_not_quantize)
            return m.decode(latents)

        if not self._patch_distributed():
            return decode(z)
        vqf = self.split_input_params.get("vqf", 4)
        return tiled_apply(decode, z, ks=min(self._split("ks", 128) // vqf, z.shape[2]),
                           stride=max(self._split("stride", 64) // vqf, 1), out_scale=vqf,
                           **self._fold_weights())

    def get_learned_conditioning(self, c):
        """The cond stage's conditioning for ``c``: token ids or class ids
        through its encoder; images through the first stage where it is the
        cond stage (unscaled, a posterior's mode); ``c`` itself for an
        unconditional model; a cond stage without ``encode`` (the
        super-resolution model's ``torch.nn.Identity``) is called."""
        if self.cond_stage_model is None:
            return c
        if self.cond_stage_is_first_stage:
            encoding = self.encode_first_stage(c)
            return encoding.mode() if isinstance(encoding, DiagonalGaussian) else encoding
        encode = getattr(self.cond_stage_model, "encode", None)
        return self.cond_stage_model(c) if encode is None else encode(c)
