"""Super-resolution (port of ``prepare_sr_cond`` and ``SuperResPipeline``
from ``sd_tpu/pipelines/superres.py``, the reference notebook's LDM-SR).

The SR model (``configs/bsr_sr.yaml``: concat conditioning on the LR image,
``cond_stage_key: LR_image``, a VQ-f4 first stage) upsamples a LR image by
``up_f`` by diffusing in the first stage's latent over the output
resolution, conditioned on the LR image in [-1, 1] resized to the latent's
size (bicubic as ``jax.image.resize`` computes it, ``ops/resize.py``; the
identity for bsr_sr, whose latent is the LR image's size). At an output of
at least ``tile_threshold`` that is larger than ``tile_ks`` (the
reference's gate) the LR image is tiled in LR space (patches of
``tile_ks / up_f`` at a stride of ``tile_stride / up_f``) and every tile is
upsampled in one batch: one DDIM sample and one decode for all of them,
stitched by ``pipelines/tiled.py``. DDIM's draws come from ``generator``,
or are given: ``x_T`` and the per-step ``noise``, NHWC over the batch of
tiles, as ``sd_tpu``'s public boundary lays them out.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sd_tpu_torch.models.ldm import LatentDiffusion
from sd_tpu_torch.ops.resize import resize
from sd_tpu_torch.pipelines.tiled import tiled_apply
from sd_tpu_torch.samplers.common import randn
from sd_tpu_torch.samplers.ddim import ddim_sample

__all__ = ["SuperResPipeline", "prepare_sr_cond"]


def prepare_sr_cond(lr_image: np.ndarray, up_f: int = 4) -> Tuple[np.ndarray, Tuple[int, int]]:
    """A LR image HWC (uint8, or float in [0, 1]) → (``[1, h, w, 3]``
    float32 in [-1, 1], the output's (H, W))."""
    img = np.asarray(lr_image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    h, w = img.shape[:2]
    return (img[None] * 2.0 - 1.0).astype(np.float32), (h * up_f, w * up_f)


@dataclasses.dataclass
class SuperResPipeline:
    """Concat-conditioned SR sampling with ``ldm``, tiled past the gate.
    After each request ``last_latents`` holds the sampled latents of the
    batch of tiles ``[N, h, w, C]``, ``last_output`` the [0, 1] float image
    ``[1, H, W, 3]`` before the uint8 rounding (host numpy), and
    ``last_timings`` its seconds per stage (device work included)."""

    ldm: LatentDiffusion
    up_f: int = 4
    vqf: int = 4  # the first stage's downsampling factor (bsr_sr's f4)
    tile_threshold: int = 128
    tile_ks: int = 128
    tile_stride: int = 64
    last_latents: Optional[torch.Tensor] = None
    last_output: Optional[np.ndarray] = None
    last_timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return next(self.ldm.parameters()).device

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tiled(self, out_hw: Tuple[int, int]) -> bool:
        """The reference's gate: the output at least ``tile_threshold`` on
        its longer side and larger than one tile."""
        out_h, out_w = out_hw
        return (max(out_h, out_w) >= self.tile_threshold
                and (out_h > self.tile_ks or out_w > self.tile_ks))

    @torch.inference_mode()
    def __call__(self, lr_image: np.ndarray, generator: Optional[torch.Generator] = None,
                 steps: int = 50, eta: float = 1.0, x_T=None,
                 noise: Optional[Sequence] = None) -> np.ndarray:
        """``lr_image`` HWC → the uint8 image ``[1, H·up_f, W·up_f, 3]``,
        DDIM ``steps`` at ``eta``."""
        t0 = time.perf_counter()
        self.last_timings = {}
        cond_img, out_hw = prepare_sr_cond(lr_image, self.up_f)
        cond = torch.from_numpy(cond_img).to(self.device).permute(0, 3, 1, 2)
        sample = lambda c: self._sample(c, generator, steps, eta, x_T, noise)
        if self.tiled(out_hw):
            out = tiled_apply(sample, cond, ks=self.tile_ks // self.up_f,
                              stride=self.tile_stride // self.up_f, out_scale=self.up_f)
        else:
            out = sample(cond)
        out = torch.clamp((out.float() + 1.0) / 2.0, 0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy()
        self.last_output = out
        self.last_timings["total_s"] = time.perf_counter() - t0
        return (out * 255.0 + 0.5).astype(np.uint8)

    def _sample(self, cond_img: torch.Tensor, generator, steps: int, eta: float, x_T,
                noise) -> torch.Tensor:
        """LR images ``[N, 3, h, w]`` in [-1, 1] → ``[N, 3, h·up_f, w·up_f]``
        in [-1, 1]: one DDIM sample over the batch, one decode."""
        ldm, device = self.ldm, self.device
        n, _, h, w = cond_img.shape
        lh, lw = h * self.up_f // self.vqf, w * self.up_f // self.vqf
        shape = (n, lh, lw, ldm.model.diffusion_model.config.out_channels)
        if x_T is None:
            x_T = randn(shape, generator, device)
        x = torch.as_tensor(x_T, dtype=torch.float32, device=device)
        if tuple(x.shape) != shape:
            raise ValueError(f"x_T has shape {tuple(x.shape)}, expected {shape}")
        if noise is not None:
            noise = [torch.as_tensor(z, device=device).permute(0, 3, 1, 2) for z in noise]
        cond = {"c_concat": resize(cond_img, (lh, lw), "bicubic")}
        t0 = time.perf_counter()
        z = ddim_sample(ldm.apply_model, ldm.schedule, x.permute(0, 3, 1, 2), cond,
                        num_steps=steps, eta=eta, generator=generator, noise=noise)
        self._sync()
        t1 = time.perf_counter()
        out = ldm.decode_first_stage(z)
        self._sync()
        self.last_timings.update(sample_s=t1 - t0, decode_s=time.perf_counter() - t1)
        self.last_latents = z.permute(0, 2, 3, 1)
        return out
