"""Ancestral DDPM sampling and progressive denoising (port of
``sd_tpu/samplers/ancestral.py``).

The full reverse chain over every DDPM timestep, T-1 down to 0: eps (or x0)
from the model with optional classifier-free guidance, the x0 estimate
clipped to [-1, 1] and passed through ``quantize_x0`` where given, then a
draw from the posterior q(x_{t-1} | x_t, x0) with ``temperature`` and
``noise_dropout`` on its noise, and no noise at t = 0. With ``mask`` (1
where ``x0`` is kept) each step first blends in ``x0`` noised to level t.
The loop is plain Python: one UNet call a step.

Draws, per step and in this order, as ``sd_tpu``'s four-way key split
gives them: the blend's noise where ``mask`` is given, the posterior noise
(not at t = 0), and the dropout's keep mask where ``noise_dropout`` is above
0. Each comes from ``generator`` or from the per-step sequence given for it
(``mask_noise``, ``noise``, ``dropout_keep``); ``x_T`` is drawn first where
it is not given.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from sd_tpu_torch.core.schedules import DiffusionSchedule, predict_start_from_noise, q_posterior
from sd_tpu_torch.samplers.common import (
    EpsModel,
    apply_noise_dropout,
    make_guided_eps,
    mask_blend,
    randn,
    stack_intermediates,
    step_draw,
)

__all__ = ["p_sample_loop", "progressive_denoising"]


def p_sample_loop(model_fn: EpsModel, schedule: DiffusionSchedule, shape, cond=None,
                  generator: Optional[torch.Generator] = None, uncond=None,
                  guidance_scale: float = 1.0, x_T: Optional[torch.Tensor] = None,
                  clip_denoised: bool = True, quantize_x0: Optional[Callable] = None,
                  temperature: float = 1.0, noise_dropout: float = 0.0,
                  mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
                  timesteps: Optional[int] = None, parameterization: str = "eps",
                  log_every_t: int = 0, noise: Optional[Sequence[torch.Tensor]] = None,
                  mask_noise: Optional[Sequence[torch.Tensor]] = None,
                  dropout_keep: Optional[Sequence[torch.Tensor]] = None):
    """The ancestral reverse chain x_T → x_0 over the first ``timesteps``
    DDPM steps (all of them by default). ``x_T`` of ``shape`` is drawn from
    ``generator``, on its device, where it is not given. Returns x_0, or
    ``(x_0, {"x_inter", "pred_x0"})`` of every ``log_every_t``-th step with
    ``log_every_t``."""
    if mask is not None and x0 is None:
        raise ValueError("mask requires x0")
    eps = make_guided_eps(model_fn, cond, uncond, guidance_scale)
    total = int(timesteps if timesteps is not None else schedule.num_timesteps)
    if x_T is None:
        x_T = randn(tuple(shape), generator, "cpu" if generator is None else generator.device)
    x = x_T
    logs = []
    for i, t in enumerate(range(total - 1, -1, -1)):
        t_vec = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        if mask is not None:
            x = mask_blend(schedule, x, x0, mask, t_vec, step_draw(mask_noise, i, x, generator))
        model_out = eps(x, t_vec)
        if parameterization == "eps":
            x_recon = predict_start_from_noise(schedule, x, t_vec, model_out)
        elif parameterization == "x0":
            x_recon = model_out
        else:
            raise NotImplementedError(f"parameterization {parameterization!r}")
        if clip_denoised:
            x_recon = torch.clamp(x_recon, -1.0, 1.0)
        if quantize_x0 is not None:
            x_recon = quantize_x0(x_recon)
        mean, _, log_var = q_posterior(schedule, x_recon, x, t_vec)
        x_prev = mean
        if t > 0:
            z = step_draw(noise, i, x, generator) * temperature
            if noise_dropout > 0.0:
                keep = None if dropout_keep is None else dropout_keep[i]
                z = apply_noise_dropout(z, noise_dropout, generator, keep)
            x_prev = mean + torch.exp(0.5 * log_var) * z
        x = x_prev
        if log_every_t:
            logs.append((x, x_recon))
    if mask is not None:
        x = x0 * mask + (1.0 - mask) * x
    if log_every_t:
        return x, stack_intermediates(logs, log_every_t)
    return x


def progressive_denoising(model_fn: EpsModel, schedule: DiffusionSchedule, shape, cond=None,
                          generator: Optional[torch.Generator] = None, uncond=None,
                          guidance_scale: float = 1.0, x_T: Optional[torch.Tensor] = None,
                          clip_denoised: bool = True, temperature: float = 1.0,
                          noise_dropout: float = 0.0, mask: Optional[torch.Tensor] = None,
                          x0: Optional[torch.Tensor] = None, timesteps: Optional[int] = None,
                          log_every_t: int = 50, **draws):
    """The reverse chain recording the x0 estimates, the "denoise row":
    ``(x_0, pred_x0 [K, ...])`` with the estimate of every
    ``log_every_t``-th step (``(x_0, None)`` with ``log_every_t`` 0).
    ``draws`` are :func:`p_sample_loop`'s ``noise``, ``mask_noise`` and
    ``dropout_keep``."""
    out = p_sample_loop(model_fn, schedule, shape, cond=cond, generator=generator,
                        uncond=uncond, guidance_scale=guidance_scale, x_T=x_T,
                        clip_denoised=clip_denoised, temperature=temperature,
                        noise_dropout=noise_dropout, mask=mask, x0=x0, timesteps=timesteps,
                        log_every_t=log_every_t, **draws)
    if not log_every_t:
        return out, None
    img, inter = out
    return img, inter["pred_x0"]
