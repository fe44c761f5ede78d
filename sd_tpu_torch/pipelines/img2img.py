"""img2img, SDEdit, and inpainting (port of ``preprocess_image``,
``preprocess_mask``, ``Img2ImgPipeline`` and ``InpaintPipeline`` from
``sd_tpu/pipelines/img2img.py``).

The init image is floored to multiples of 32 and mapped to [-1, 1], tiled
to the batch and encoded by the first stage, each copy with its own
posterior draw; then DDIM's stochastic encode diffuses the latents to grid
position ``t_enc - 1`` with ``t_enc = int(strength * steps)``, and DDIM at
eta 0 with classifier-free guidance decodes them from there; the VAE
decodes the result to uint8 with the reference's ``(x * 255 + 0.5)``. At
``t_enc == 0`` the encoded latents are decoded as they are. The public
boundary keeps ``sd_tpu``'s layout (images and draws NHWC); inside, the
models run NCHW.

Inpainting (``scripts/inpaint.py``'s flow, for a concat-conditioned LDM
whose cond stage is its first stage, as ``inpainting_big``): the image
with the region to fill zeroed is encoded to its scaled latent, the mask
max-pooled to the latent's size (``preprocess_mask``, as ``sd_tpu`` pools
it; the reference interpolates) is concatenated to it as ``c_concat``, DDIM
at eta 0 samples from x_T, and the decoded image fills the masked region:
``(1 - mask) * image + mask * sample`` on [0, 1], so the pixels outside the
mask are the input's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sd_tpu_torch.models.ldm import LatentDiffusion
from sd_tpu_torch.pipelines.txt2img import Txt2ImgPipeline
from sd_tpu_torch.samplers.common import randn
from sd_tpu_torch.samplers.ddim import ddim_decode, ddim_sample, ddim_stochastic_encode

__all__ = ["Img2ImgPipeline", "InpaintPipeline", "preprocess_image", "preprocess_mask"]


def preprocess_image(img: np.ndarray) -> np.ndarray:
    """HWC uint8 or float image → ``[1, H', W', C]`` float32 in [-1, 1], H
    and W floored to multiples of 32."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    h, w = img.shape[:2]
    h, w = (h // 32) * 32, (w // 32) * 32
    img = img[:h, :w]
    return (img[None] * 2.0 - 1.0).astype(np.float32)


def preprocess_mask(mask: np.ndarray, downsample: int = 8) -> np.ndarray:
    """HW {0, 1} mask (or HWC, its first channel) → ``[1, h, w, 1]`` float32
    at the latent resolution, each latent pixel the max of its block; 1 is
    the region to inpaint."""
    mask = np.asarray(mask).astype(np.float32)
    if mask.ndim == 3:
        mask = mask[..., 0]
    h, w = mask.shape
    mh, mw = h // downsample, w // downsample
    small = mask.reshape(mh, downsample, mw, downsample).max(axis=(1, 3))
    return small[None, :, :, None]


@dataclasses.dataclass
class Img2ImgPipeline:
    """Strength-controlled image-to-image translation around a
    :class:`Txt2ImgPipeline`'s model and tokenizer. After each request,
    ``last_latents`` holds the latents it decoded ``[B, h, w, C]`` and
    ``last_timings`` its seconds per stage (device work included)."""

    base: Txt2ImgPipeline
    last_latents: Optional[torch.Tensor] = None
    last_timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @torch.inference_mode()
    def __call__(self, init_image: np.ndarray, prompts: Sequence[str],
                 generator: Optional[torch.Generator] = None, strength: float = 0.75,
                 steps: int = 50, guidance_scale: float = 7.5,
                 negative_prompts: Optional[Sequence[str]] = None,
                 noise: Optional[Sequence[torch.Tensor]] = None) -> np.ndarray:
        """Returns uint8 images ``[B, H', W', 3]`` (host numpy), one per
        prompt. The draws, the posterior's noise and the stochastic encode's
        (each ``[B, h, w, C]``), come from ``generator`` or are given as
        ``noise``."""
        if not 0.0 <= strength <= 1.0:
            raise ValueError(f"strength must be in [0, 1], got {strength}")
        base = self.base
        ldm, device = base.ldm, base.device
        prompts = list(prompts)
        b = len(prompts)
        clock = [time.perf_counter()]

        def lap():
            base._sync()
            clock.append(time.perf_counter())

        def draw(i, like):
            z = randn(like.shape, generator, device) if noise is None else torch.as_tensor(
                noise[i], device=device).permute(0, 3, 1, 2)
            return z.to(like.dtype)

        cond = base.encode_prompts(prompts)
        uncond = None
        if guidance_scale != 1.0:
            neg = list(negative_prompts) if negative_prompts is not None else [""] * b
            if len(neg) != b:
                raise ValueError(f"{len(neg)} negative prompts for {b} prompts")
            uncond = base.encode_prompts(neg)
        x = torch.from_numpy(preprocess_image(init_image)).to(device).permute(0, 3, 1, 2)
        posterior = ldm.encode_first_stage(x.repeat(b, 1, 1, 1))
        z = ldm.scale_factor * posterior.sample(noise=draw(0, posterior.mean))
        z = z.float()
        lap()
        t_enc = int(strength * steps)
        if t_enc > 0:
            z = ddim_stochastic_encode(ldm.schedule, z, t_enc - 1, num_steps=steps,
                                       noise=draw(1, z))
            z = ddim_decode(ldm.apply_model, ldm.schedule, z, cond, t_enc, num_steps=steps,
                            uncond=uncond, guidance_scale=guidance_scale)
        lap()
        self.last_latents = z.permute(0, 2, 3, 1)
        images = base.decode_to_uint8(self.last_latents).cpu().numpy()
        lap()
        names = ("encode_s", "sample_s", "decode_s")
        self.last_timings = {k: t1 - t0 for k, t0, t1 in zip(names, clock, clock[1:])}
        self.last_timings["total_s"] = clock[-1] - clock[0]
        return images


@dataclasses.dataclass
class InpaintPipeline:
    """Concat-conditioned inpainting with ``ldm`` (UNet input channels: the
    latent's, the cond latent's and the mask's; 7 for ``inpainting_big``),
    ``downsample`` its first stage's factor (4 for VQ-f4). After each
    request ``last_latents`` holds the sampled latents ``[1, h, w, C]``,
    ``last_composite`` the [0, 1] float composite ``[1, H', W', 3]`` (host
    numpy) and ``last_timings`` its seconds per stage (device work
    included)."""

    ldm: LatentDiffusion
    downsample: int = 8
    last_latents: Optional[torch.Tensor] = None
    last_composite: Optional[np.ndarray] = None
    last_timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return next(self.ldm.parameters()).device

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def __call__(self, image: np.ndarray, mask: np.ndarray,
                 generator: Optional[torch.Generator] = None, steps: int = 50,
                 x_T=None) -> np.ndarray:
        """``image`` HWC (uint8 or float in [0, 1]), ``mask`` HW with 1 where
        to fill. Returns the uint8 composite ``[1, H', W', 3]`` (H, W floored
        to multiples of 32). ``x_T`` (``[1, h, w, C]``) or a draw from
        ``generator`` starts DDIM."""
        ldm, device = self.ldm, self.device
        clock = [time.perf_counter()]

        def lap():
            self._sync()
            clock.append(time.perf_counter())

        img = torch.from_numpy(preprocess_image(image)).to(device).permute(0, 3, 1, 2)
        h, w = img.shape[2:]
        m_full = torch.from_numpy(np.asarray(mask, np.float32)).to(device)[None, None, :h, :w]
        m_lat = torch.from_numpy(preprocess_mask(mask, self.downsample)).to(device)
        c_img = ldm.get_first_stage_encoding(ldm.encode_first_stage(img * (1.0 - m_full)))
        cond = {"c_concat": torch.cat([c_img.float(), m_lat.permute(0, 3, 1, 2)], dim=1)}
        shape = (1, c_img.shape[2], c_img.shape[3], c_img.shape[1])
        if x_T is None:
            x_T = randn(shape, generator, device)
        x = torch.as_tensor(x_T, dtype=torch.float32, device=device)
        if tuple(x.shape) != shape:
            raise ValueError(f"x_T has shape {tuple(x.shape)}, expected {shape}")
        lap()
        z = ddim_sample(ldm.apply_model, ldm.schedule, x.permute(0, 3, 1, 2), cond,
                        num_steps=steps)
        lap()
        pred = torch.clamp((ldm.decode_first_stage(z).float() + 1.0) / 2.0, 0.0, 1.0)
        img01 = torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)
        out = ((1.0 - m_full) * img01 + m_full * pred).permute(0, 2, 3, 1).cpu().numpy()
        lap()
        self.last_latents = z.permute(0, 2, 3, 1)
        self.last_composite = out
        names = ("encode_s", "sample_s", "decode_s")
        self.last_timings = {k: t1 - t0 for k, t0, t1 in zip(names, clock, clock[1:])}
        self.last_timings["total_s"] = clock[-1] - clock[0]
        return (out * 255.0 + 0.5).astype(np.uint8)
