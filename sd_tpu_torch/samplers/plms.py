"""PLMS sampler, SD's default (port of ``sd_tpu/samplers/plms.py``).

The bootstrap step is the pseudo improved Euler step with two UNet calls;
steps 1..S-1 use Adams-Bashforth of order 2, 3, then 4 on a ring of the last
three eps values. The loop is plain Python: ``S + 1`` UNet calls in all.
PLMS runs at eta = 0, so it injects no noise (``temperature`` is inert, as
in ``sd_tpu``); with ``mask`` it draws the blend's noise once a step, before
the step's first UNet call, from ``generator`` or ``mask_noise[i]``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.samplers.common import (
    EpsModel,
    build_ddim_tables,
    ddim_step_from_eps,
    make_guided_eps,
    mask_blend,
    stack_intermediates,
    step_draw,
)

__all__ = ["plms_sample"]


def plms_sample(model_fn: EpsModel, schedule: DiffusionSchedule, x_T: torch.Tensor,
                cond: torch.Tensor, num_steps: int = 50, uncond=None,
                guidance_scale: float = 1.0, temperature: float = 1.0,
                mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                mask_noise: Optional[Sequence[torch.Tensor]] = None,
                quantize_x0: Optional[Callable] = None,
                score_corrector: Optional[Callable] = None, log_every_t: int = 0):
    """Run the reverse PLMS loop (eta = 0) from ``x_T``; returns the final
    latents (and the intermediates with ``log_every_t``)."""
    if mask is not None and x0 is None:
        raise ValueError("mask requires x0")
    tables = build_ddim_tables(schedule, num_steps)
    eps = make_guided_eps(model_fn, cond, uncond, guidance_scale, score_corrector)
    idx = np.arange(len(tables.timesteps))[::-1]  # descending time
    t_seq = tables.timesteps[idx]
    t_next_seq = np.concatenate([t_seq[1:], t_seq[-1:]])
    a_seq = tables.alphas[idx]
    ap_seq = tables.alphas_prev[idx]
    s1m_seq = tables.sqrt_one_minus_alphas[idx]

    x = x_T
    t_vec = lambda t: torch.full((x.shape[0],), int(t), dtype=torch.long, device=x.device)
    step = lambda x, e, i: ddim_step_from_eps(x, e, a_seq[i], ap_seq[i], s1m_seq[i],
                                              temperature=temperature,
                                              quantize_x0=quantize_x0)

    def blend(x, i):
        if mask is None:
            return x
        return mask_blend(schedule, x, x0, mask, t_vec(t_seq[i]),
                          step_draw(mask_noise, i, x, generator))

    # bootstrap (i = 0): pseudo improved Euler
    x = blend(x, 0)
    e_t = eps(x, t_vec(t_seq[0]))
    x_prev_1, _ = step(x, e_t, 0)
    e_t_next = eps(x_prev_1, t_vec(t_next_seq[0]))
    x, pred_x0 = step(x, (e_t + e_t_next) / 2.0, 0)
    logs = [(x, pred_x0)]
    old = [e_t, e_t, e_t]

    for i in range(1, len(t_seq)):
        x = blend(x, i)
        e_t = eps(x, t_vec(t_seq[i]))
        order = min(i, 3)
        if order == 1:
            e_prime = (3.0 * e_t - old[0]) / 2.0
        elif order == 2:
            e_prime = (23.0 * e_t - 16.0 * old[0] + 5.0 * old[1]) / 12.0
        else:
            e_prime = (55.0 * e_t - 59.0 * old[0] + 37.0 * old[1] - 9.0 * old[2]) / 24.0
        x, pred_x0 = step(x, e_prime, i)
        if log_every_t:
            logs.append((x, pred_x0))
        old = [e_t, old[0], old[1]]
    if mask is not None and len(t_seq) > 1:
        # sd_tpu's single-step run returns before its final blend
        x = x0 * mask + (1.0 - mask) * x
    if log_every_t:
        return x, stack_intermediates(logs, log_every_t)
    return x
