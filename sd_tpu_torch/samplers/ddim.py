"""DDIM sampler (port of ``sd_tpu/samplers/ddim.py``).

Deterministic or eta-stochastic sampling over a subsetted grid with
classifier-free guidance, mask-blend inpainting, temperature, noise dropout
and x0 quantization; and :func:`ddim_stochastic_encode` /
:func:`ddim_decode`, img2img's two halves. One UNet call a step: ``S`` per
request. The loop is plain Python over host float32 tables.

Draws, per step and in this order, as ``sd_tpu``'s four-way key split
gives them: the blend's noise where ``mask`` is given, the injected noise
where sigma is not 0, and the dropout's keep mask where ``noise_dropout`` is
above 0. Each comes from ``generator`` or from the per-step sequence given
for it (``mask_noise``, ``noise``, ``dropout_keep``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.samplers.common import (
    EpsModel,
    apply_noise_dropout,
    build_ddim_tables,
    build_original_step_tables,
    ddim_step_from_eps,
    make_guided_eps,
    mask_blend,
    stack_intermediates,
    step_draw,
)

__all__ = ["ddim_sample", "ddim_stochastic_encode", "ddim_decode"]


def ddim_sample(model_fn: EpsModel, schedule: DiffusionSchedule, x_T: torch.Tensor,
                cond=None, num_steps: int = 50, eta: float = 0.0, uncond=None,
                guidance_scale: float = 1.0, generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None,
                mask_noise: Optional[Sequence[torch.Tensor]] = None,
                dropout_keep: Optional[Sequence[torch.Tensor]] = None,
                temperature: float = 1.0, mask: Optional[torch.Tensor] = None,
                x0: Optional[torch.Tensor] = None, quantize_x0: Optional[Callable] = None,
                score_corrector: Optional[Callable] = None, noise_dropout: float = 0.0,
                timestep_method: str = "uniform", log_every_t: int = 0,
                t_start_index: Optional[int] = None, use_original_steps: bool = False):
    """Run the reverse DDIM loop from ``x_T``; ``cond`` (and ``uncond``) a
    tensor, a dict of them, or None for an unconditional model.

    ``t_start_index`` truncates the grid (img2img); ``use_original_steps``
    runs the whole DDPM grid with its own tables. ``mask`` (1 where ``x0``
    is kept) needs ``x0``; the known region is ``x0`` exactly at the end.
    """
    if mask is not None and x0 is None:
        raise ValueError("mask requires x0")
    if use_original_steps:
        tables = build_original_step_tables(schedule, eta=eta)
    else:
        tables = build_ddim_tables(schedule, num_steps, eta=eta, method=timestep_method)
    eps = make_guided_eps(model_fn, cond, uncond, guidance_scale, score_corrector)
    total = len(tables.timesteps) if t_start_index is None else int(t_start_index)

    x = x_T
    logs = []
    for i, j in enumerate(range(total - 1, -1, -1)):
        t_vec = torch.full((x.shape[0],), int(tables.timesteps[j]), dtype=torch.long,
                           device=x.device)
        if mask is not None:
            x = mask_blend(schedule, x, x0, mask, t_vec, step_draw(mask_noise, i, x, generator))
        e_t = eps(x, t_vec)
        sigma = tables.sigmas[j]
        z = None
        if sigma != 0:
            z = step_draw(noise, i, x, generator)
            if noise_dropout > 0.0:
                keep = None if dropout_keep is None else dropout_keep[i]
                z = apply_noise_dropout(z, noise_dropout, generator, keep)
        x, pred_x0 = ddim_step_from_eps(x, e_t, tables.alphas[j], tables.alphas_prev[j],
                                        tables.sqrt_one_minus_alphas[j], sigma, z,
                                        temperature, quantize_x0)
        if log_every_t:
            logs.append((x, pred_x0))
    if mask is not None:
        x = x0 * mask + (1.0 - mask) * x
    if log_every_t:
        return x, stack_intermediates(logs, log_every_t)
    return x


def ddim_stochastic_encode(schedule: DiffusionSchedule, x0: torch.Tensor, t_enc_index,
                           num_steps: int = 50, noise: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None,
                           use_original_steps: bool = False) -> torch.Tensor:
    """Diffuse ``x0`` forward to DDIM grid position ``t_enc_index`` (an int
    or a ``[B]`` tensor): ``sqrt(ᾱ) x0 + sqrt(1-ᾱ) noise`` on the sub-grid."""
    if use_original_steps:
        sqrt_a = schedule.sqrt_alphas_cumprod
        sqrt_1ma = schedule.sqrt_one_minus_alphas_cumprod
    else:
        tables = build_ddim_tables(schedule, num_steps)
        sqrt_a = np.sqrt(tables.alphas)
        sqrt_1ma = tables.sqrt_one_minus_alphas
    if noise is None:
        noise = step_draw(None, 0, x0, generator)
    t = torch.as_tensor(t_enc_index, dtype=torch.long)
    shape = tuple(t.shape) + (1,) * (x0.ndim - t.ndim)
    gather = lambda table: torch.from_numpy(table)[t].reshape(shape).to(x0.device, x0.dtype)
    return gather(sqrt_a) * x0 + gather(sqrt_1ma) * noise


def ddim_decode(model_fn: EpsModel, schedule: DiffusionSchedule, x_latent: torch.Tensor,
                cond: torch.Tensor, t_start_index: int, num_steps: int = 50, uncond=None,
                guidance_scale: float = 1.0, use_original_steps: bool = False) -> torch.Tensor:
    """The reverse loop at eta 0 from grid position ``t_start_index`` down
    (img2img's denoising half); it draws nothing."""
    return ddim_sample(model_fn, schedule, x_latent, cond, num_steps=num_steps, eta=0.0,
                       uncond=uncond, guidance_scale=guidance_scale,
                       t_start_index=t_start_index, use_original_steps=use_original_steps)
