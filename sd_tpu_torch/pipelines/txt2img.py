"""txt2img pipeline (port of ``sd_tpu/pipelines/txt2img.py``).

tokenize → CLIP encode (cond, and the empty-string uncond for guidance) →
PLMS with classifier-free guidance → VAE decode → uint8 → watermark. The
public boundary keeps ``sd_tpu``'s layout: ``x_T`` is ``[B, h, w, C]`` and
images are uint8 ``[B, H, W, 3]``; inside, the models run NCHW. The safety
checker is not ported yet (without trained weights it flags nothing).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from sd_tpu_torch.models.ldm import LatentDiffusion
from sd_tpu_torch.samplers.plms import plms_sample

__all__ = ["Txt2ImgPipeline"]


@dataclasses.dataclass
class Txt2ImgPipeline:
    """End-to-end text-to-image sampling around a :class:`LatentDiffusion`.

    ``tokenizer`` maps ``List[str]`` to int token ids ``[B, N]``;
    ``watermarker`` maps host uint8 ``[B, H, W, 3]`` to the same. After each
    call, ``last_latents`` holds the sampled latents ``[B, h, w, C]`` and
    ``last_timings`` the seconds of each stage (device work included).
    """

    ldm: LatentDiffusion
    tokenizer: Callable[[Sequence[str]], Any]
    watermarker: Optional[Callable[[np.ndarray], np.ndarray]] = None
    latent_channels: int = 4
    downsample: int = 8
    last_latents: Optional[torch.Tensor] = None
    last_timings: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return next(self.ldm.parameters()).device

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def encode_prompts(self, prompts: Sequence[str]) -> torch.Tensor:
        tokens = torch.as_tensor(np.asarray(self.tokenizer(list(prompts))), dtype=torch.long,
                                 device=self.device)
        return self.ldm.get_learned_conditioning(tokens)

    @torch.inference_mode()
    def sample_latents(self, cond: torch.Tensor, uncond: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None, height: int = 512,
                       width: int = 512, steps: int = 50, guidance_scale: float = 7.5,
                       x_T=None) -> torch.Tensor:
        """PLMS latents ``[B, h, w, C]`` float32; ``x_T`` (same layout) or a
        draw from ``generator``."""
        shape = (cond.shape[0], height // self.downsample, width // self.downsample,
                 self.latent_channels)
        if x_T is None:
            x_T = torch.randn(shape, generator=generator, device=self.device)
        x = torch.as_tensor(x_T, dtype=torch.float32, device=self.device)
        if tuple(x.shape) != shape:
            raise ValueError(f"x_T has shape {tuple(x.shape)}, expected {shape}")
        z = plms_sample(self.ldm.apply_model, self.ldm.schedule, x.permute(0, 3, 1, 2),
                        cond, num_steps=steps, uncond=uncond, guidance_scale=guidance_scale)
        return z.permute(0, 2, 3, 1)

    @torch.inference_mode()
    def decode_to_uint8(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents ``[B, h, w, C]`` → uint8 ``[B, H, W, 3]`` on the device, with
        the reference's ``(x * 255 + 0.5)`` rounding."""
        x = self.ldm.decode_first_stage(latents.permute(0, 3, 1, 2))
        x = torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
        x = torch.clamp(x.float() * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
        return x.permute(0, 2, 3, 1)

    def __call__(self, prompts: Sequence[str], generator: Optional[torch.Generator] = None,
                 height: int = 512, width: int = 512, steps: int = 50,
                 guidance_scale: float = 7.5, x_T=None) -> np.ndarray:
        """Returns uint8 images ``[B, H, W, 3]`` (host numpy); the guidance's
        unconditional prompt is the empty string."""
        prompts = list(prompts)
        t0 = time.perf_counter()
        cond = self.encode_prompts(prompts)
        uncond = None
        if guidance_scale != 1.0:
            uncond = self.encode_prompts([""] * len(prompts))
        self._sync()
        t1 = time.perf_counter()
        z = self.sample_latents(cond, uncond, generator, height=height, width=width,
                                steps=steps, guidance_scale=guidance_scale, x_T=x_T)
        self._sync()
        t2 = time.perf_counter()
        images = self.decode_to_uint8(z).cpu().numpy()
        t3 = time.perf_counter()
        if self.watermarker is not None:
            images = self.watermarker(images)
        self.last_latents = z
        self.last_timings = {"encode_s": t1 - t0, "sample_s": t2 - t1, "decode_s": t3 - t2,
                             "total_s": time.perf_counter() - t0}
        return images
