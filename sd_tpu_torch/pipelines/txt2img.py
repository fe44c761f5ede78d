"""txt2img pipeline (port of ``sd_tpu/pipelines/txt2img.py``).

tokenize → CLIP encode (cond, and for guidance the negative prompts or the
empty string) → a sampler with classifier-free guidance (``plms``, ``ddim``
with ``eta``, or ``dpm``: DPM-Solver++ 2M) → VAE decode → uint8 → safety
scores → one fetch → placeholder replacement → watermark. The public
boundary keeps ``sd_tpu``'s layout: ``x_T`` is ``[B, h, w, C]`` and images
are uint8 ``[B, H, W, 3]``; inside, the models run NCHW.

:meth:`Txt2ImgPipeline._issue` queues a request's device work without
waiting for it (CUDA's stream is asynchronous), and
:meth:`Txt2ImgPipeline._finish` fetches and post-processes it;
:meth:`Txt2ImgPipeline.map_batches` keeps ``depth`` requests in flight so
that the host's work on request i overlaps the card's on request i+1.

With a ``mesh`` (``parallel/mesh.py``, ``sd_tpu``'s field) every rank of
its ``data`` dim serves the request together: the prompts, the negative
prompts and ``x_T`` are sharded by rank (contiguous blocks of rows), each
rank encodes, samples, decodes and scores its rows, and the uint8 images,
the flags and the latents are gathered in rank order, so every rank returns
the whole batch. The generator's draws are the whole batch's, of which a
rank takes its rows (``core/draws.py::RowDraws``): the images do not
depend on the number of ranks. ``last_timings`` are the rank's own.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from sd_tpu_torch.core.draws import RowDraws
from sd_tpu_torch.models.ldm import LatentDiffusion
from sd_tpu_torch.parallel.mesh import all_gather_rows, axis_info, take_rows
from sd_tpu_torch.pipelines.safety import SafetyChecker, replace_flagged
from sd_tpu_torch.samplers.common import randn
from sd_tpu_torch.samplers.ddim import ddim_sample
from sd_tpu_torch.samplers.dpm_solver import dpm_solver_sample
from sd_tpu_torch.samplers.plms import plms_sample

__all__ = ["Txt2ImgPipeline"]


@dataclasses.dataclass
class Txt2ImgPipeline:
    """End-to-end text-to-image sampling around a :class:`LatentDiffusion`.

    ``tokenizer`` maps ``List[str]`` to int token ids ``[B, N]``;
    ``safety_checker`` scores the decoded uint8 batch on the device;
    ``watermarker`` maps host uint8 ``[B, H, W, 3]`` to the same. After each
    request, ``last_latents`` holds its latents ``[B, h, w, C]``,
    ``last_safety_flags`` its flags (None without a checker) and
    ``last_timings`` its seconds: per stage (device work included) where the
    request was served alone, ``total_s`` only in :meth:`map_batches`.
    """

    ldm: LatentDiffusion
    tokenizer: Callable[[Sequence[str]], Any]
    safety_checker: Optional[SafetyChecker] = None
    watermarker: Optional[Callable[[np.ndarray], np.ndarray]] = None
    latent_channels: int = 4
    downsample: int = 8
    # a DeviceMesh whose "data" dim shards each request's batch over the ranks
    mesh: Optional[Any] = None
    last_latents: Optional[torch.Tensor] = None
    last_safety_flags: Optional[List[bool]] = None
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
                       sampler: str = "plms", eta: float = 0.0, x_T=None) -> torch.Tensor:
        """Latents ``[B, h, w, C]`` float32 from ``sampler``; ``x_T`` (same
        layout) or a draw from ``generator``, which DDIM's noise at eta > 0
        also draws from. A CPU generator gives a CUDA run the CPU's draws."""
        shape = (cond.shape[0], height // self.downsample, width // self.downsample,
                 self.latent_channels)
        if x_T is None:
            x_T = randn(shape, generator, self.device)
        x = torch.as_tensor(x_T, dtype=torch.float32, device=self.device)
        if tuple(x.shape) != shape:
            raise ValueError(f"x_T has shape {tuple(x.shape)}, expected {shape}")
        x = x.permute(0, 3, 1, 2)
        common = dict(uncond=uncond, guidance_scale=guidance_scale)
        ldm = self.ldm
        if sampler == "plms":
            z = plms_sample(ldm.apply_model, ldm.schedule, x, cond, num_steps=steps, **common)
        elif sampler == "ddim":
            z = ddim_sample(ldm.apply_model, ldm.schedule, x, cond, num_steps=steps, eta=eta,
                            generator=generator, **common)
        elif sampler in ("dpm", "dpm_solver", "dpmsolver"):
            z = dpm_solver_sample(ldm.apply_model, ldm.schedule, x, cond, num_steps=steps,
                                  **common)
        else:
            raise ValueError(f"unknown sampler {sampler!r}")
        return z.permute(0, 2, 3, 1)

    @torch.inference_mode()
    def decode_to_uint8(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents ``[B, h, w, C]`` → uint8 ``[B, H, W, 3]`` on the device, with
        the reference's ``(x * 255 + 0.5)`` rounding."""
        x = self.ldm.decode_first_stage(latents.permute(0, 3, 1, 2))
        x = torch.clamp((x + 1.0) / 2.0, 0.0, 1.0)
        x = torch.clamp(x.float() * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
        return x.permute(0, 2, 3, 1)

    def _issue(self, prompts: Sequence[str], generator: Optional[torch.Generator] = None,
               negative_prompts: Optional[Sequence[str]] = None, height: int = 512,
               width: int = 512, steps: int = 50, guidance_scale: float = 7.5,
               sampler: str = "plms", eta: float = 0.0, x_T=None, timed: bool = False) -> dict:
        """Queue one request's device work: encode, sample, decode to uint8,
        safety scores. Returns its handle for :meth:`_finish`; waits for the
        card only with ``timed``, to read each stage's seconds."""
        prompts = list(prompts)
        clock = [time.perf_counter()]

        def lap():
            if timed:
                self._sync()
                clock.append(time.perf_counter())

        neg = None
        if guidance_scale != 1.0:
            neg = list(negative_prompts) if negative_prompts is not None else [""] * len(prompts)
            if len(neg) != len(prompts):
                raise ValueError(f"{len(neg)} negative prompts for {len(prompts)} prompts")
        group, index, count = axis_info(self.mesh, "data")
        if count > 1:
            prompts, neg, x_T = (take_rows(v, index, count) for v in (prompts, neg, x_T))
            if generator is not None:
                generator = RowDraws(generator, index, count)
        cond = self.encode_prompts(prompts)
        uncond = None if neg is None else self.encode_prompts(neg)
        lap()
        z = self.sample_latents(cond, uncond, generator, height=height, width=width,
                                steps=steps, guidance_scale=guidance_scale, sampler=sampler,
                                eta=eta, x_T=x_T)
        lap()
        images = self.decode_to_uint8(z)
        lap()
        flags = self.safety_checker.nsfw_scores(images) if self.safety_checker else None
        if count > 1:
            images, z = all_gather_rows(images, group), all_gather_rows(z.contiguous(), group)
            if flags is not None:
                flags = all_gather_rows(flags.to(torch.uint8), group).bool()
        lap()
        return {"images": images, "flags": flags, "latents": z, "clock": clock}

    def _finish(self, handle: dict) -> np.ndarray:
        """Fetch a request's uint8 images (and flags), replace the flagged
        ones, watermark; sets ``last_latents``, ``last_safety_flags`` and
        ``last_timings``."""
        images = handle["images"].cpu().numpy()
        self.last_safety_flags = None
        if handle["flags"] is not None:
            flags = handle["flags"].cpu().numpy()
            images = replace_flagged(images, flags)
            self.last_safety_flags = [bool(f) for f in flags]
        if self.watermarker is not None:
            images = self.watermarker(images)
        clock = handle["clock"]
        self.last_latents = handle["latents"]
        self.last_timings = {"total_s": time.perf_counter() - clock[0]}
        if len(clock) == 5:
            names = ("encode_s", "sample_s", "decode_s", "safety_s")
            self.last_timings.update({k: b - a for k, a, b in zip(names, clock, clock[1:])})
        return images

    def __call__(self, prompts: Sequence[str], generator: Optional[torch.Generator] = None,
                 height: int = 512, width: int = 512, steps: int = 50,
                 guidance_scale: float = 7.5, x_T=None, sampler: str = "plms",
                 eta: float = 0.0, negative_prompts: Optional[Sequence[str]] = None
                 ) -> np.ndarray:
        """Returns uint8 images ``[B, H, W, 3]`` (host numpy); the guidance's
        unconditional prompts are ``negative_prompts``, else the empty
        string."""
        return self._finish(self._issue(prompts, generator, negative_prompts, height, width,
                                        steps, guidance_scale, sampler, eta, x_T, timed=True))

    def map_batches(self, requests: Iterable[dict], depth: int = 2) -> Iterator[np.ndarray]:
        """Yield the uint8 images of each request (a dict of :meth:`__call__`'s
        arguments, with ``prompts``), keeping up to ``depth`` requests queued
        on the card; ``last_safety_flags`` is request i's when its images
        are yielded."""
        inflight = collections.deque()
        for req in requests:
            inflight.append(self._issue(**req))
            if len(inflight) >= depth:
                yield self._finish(inflight.popleft())
        while inflight:
            yield self._finish(inflight.popleft())
