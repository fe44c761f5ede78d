"""Shared sampler machinery (port of ``sd_tpu/samplers/common.py``).

:func:`make_guided_eps` folds classifier-free guidance into one UNet call on
the doubled batch (unconditional half first); :func:`build_ddim_tables` and
:func:`ddim_step_from_eps` are the DDIM tables and update that PLMS reuses.
The per-step scalars stay float32 numpy values, as in ``sd_tpu``, and enter
the tensor math as Python floats.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from sd_tpu_torch.core.schedules import (
    DiffusionSchedule,
    make_ddim_sampling_parameters,
    make_ddim_timesteps,
)

__all__ = ["make_guided_eps", "DDIMTables", "build_ddim_tables", "ddim_step_from_eps"]

# eps_model(x, t_vec, cond) -> eps
EpsModel = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def make_guided_eps(model_fn: EpsModel, cond: torch.Tensor,
                    uncond: Optional[torch.Tensor] = None,
                    guidance_scale: float = 1.0) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``eps(x, t)``; with guidance, one call on ``[x, x]`` with
    ``[uncond, cond]`` and ``eps_u + scale * (eps_c - eps_u)``."""
    use_cfg = uncond is not None and guidance_scale != 1.0

    def eps(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if not use_cfg:
            return model_fn(x, t, cond)
        out = model_fn(torch.cat([x, x]), torch.cat([t, t]), torch.cat([uncond, cond]))
        e_uncond, e_cond = out.chunk(2)
        return e_uncond + guidance_scale * (e_cond - e_uncond)

    return eps


class DDIMTables(NamedTuple):
    """Per-step solver tables over the subsetted grid at eta = 0 (all shape [S])."""

    timesteps: np.ndarray
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray


def build_ddim_tables(schedule: DiffusionSchedule, num_steps: int) -> DDIMTables:
    ts = make_ddim_timesteps(num_steps, schedule.num_timesteps)
    alphas, alphas_prev = make_ddim_sampling_parameters(
        schedule.alphas_cumprod.astype(np.float64), ts)
    return DDIMTables(
        timesteps=ts,
        alphas=alphas.astype(np.float32),
        alphas_prev=alphas_prev.astype(np.float32),
        sqrt_one_minus_alphas=np.sqrt(1.0 - alphas).astype(np.float32),
    )


def ddim_step_from_eps(x: torch.Tensor, e_t: torch.Tensor, a_t, a_prev,
                       sqrt_one_minus_at) -> torch.Tensor:
    """The deterministic (eta = 0) DDIM ``x_{t-1}`` update given eps.

    The scalars are float32 table entries; their square roots are taken in
    float32, as ``sd_tpu`` takes them on device.
    """
    f32 = np.float32
    a_t, a_prev = f32(a_t), f32(a_prev)
    pred_x0 = (x - float(f32(sqrt_one_minus_at)) * e_t) / float(np.sqrt(a_t))
    dir_xt = float(np.sqrt(f32(1.0) - a_prev)) * e_t
    return float(np.sqrt(a_prev)) * pred_x0 + dir_xt
