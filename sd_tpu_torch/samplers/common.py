"""Shared sampler machinery (port of ``sd_tpu/samplers/common.py``).

:func:`make_guided_eps` folds classifier-free guidance into one UNet call on
the doubled batch (unconditional half first); :func:`wrap_model_output`
adapts an ``x_start``, ``v`` or ``score`` network to the eps interface;
:func:`build_ddim_tables`, :func:`build_original_step_tables` and
:func:`ddim_step_from_eps` are the DDIM tables and update that PLMS reuses;
:func:`mask_blend` is the training-free inpainting blend. The per-step
scalars stay float32 numpy values, as in ``sd_tpu``, and enter the tensor
math as Python floats.

Randomness: ``sd_tpu`` draws from JAX keys, which a torch generator cannot
reproduce. Each sampler here draws from a ``torch.Generator`` (on the
generator's device, then moved to the latents', so a CPU generator gives
the same draws to a CPU and a CUDA run), or takes the draws as per-step
tensors. With ``log_every_t > 0`` the DDIM and PLMS samplers return
``(x, intermediates)``, else ``x``. A ``core/draws.py`` ``RowDraws`` in place of
the generator gives a data-parallel rank its rows of the draws one process makes
for the whole batch (``parallel/sharded_sampling.py``, the LDM train step).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from sd_tpu_torch.core.schedules import (
    DiffusionSchedule,
    make_ddim_sampling_parameters,
    make_ddim_timesteps,
    q_sample,
)
from sd_tpu_torch.core.draws import RowDraws, draw

__all__ = ["make_guided_eps", "wrap_model_output", "apply_noise_dropout", "DDIMTables",
           "build_ddim_tables", "build_original_step_tables", "ddim_step_from_eps",
           "mask_blend", "randn", "step_draw", "stack_intermediates"]

# eps_model(x, t_vec, cond) -> eps
EpsModel = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def randn(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """A standard normal float32 draw from ``generator`` (or a
    :class:`RowDraws`) on its own device (the default generator of
    ``device`` without one), moved to ``device``."""
    where = generator.device if generator is not None else device
    return draw(torch.randn, shape, generator, where).to(device)


def step_draw(given: Optional[Sequence[torch.Tensor]], i: int, like: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Step ``i``'s draw: ``given[i]`` where the caller passed the draws,
    else a fresh normal draw shaped as ``like``."""
    if given is not None:
        return torch.as_tensor(given[i], device=like.device).to(like.dtype)
    return randn(like.shape, generator, like.device).to(like.dtype)


def apply_noise_dropout(noise: torch.Tensor, p: float,
                        generator: Optional[torch.Generator] = None,
                        keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dropout on the injected sampler noise: each element zeroed with
    probability ``p``, survivors scaled by ``1/(1-p)``. ``keep`` is the
    boolean mask of survivors, else drawn from ``generator``."""
    if keep is None:
        where = generator.device if generator is not None else noise.device
        keep = draw(torch.rand, noise.shape, generator, where) < 1.0 - p
    keep = torch.as_tensor(keep, device=noise.device)
    return torch.where(keep, noise / (1.0 - p), torch.zeros_like(noise))


def _interp_index(t: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(t, arange(N), table)``: linear between the integer
    points, clamped at both ends."""
    n = table.shape[0]
    t = t.float().clamp(0, n - 1)
    i = torch.clamp(torch.floor(t).long(), max=n - 2)
    w = t - i.float()
    return table[i] + w * (table[i + 1] - table[i])


def wrap_model_output(model_fn: EpsModel, schedule: DiffusionSchedule,
                      model_type: str = "noise") -> EpsModel:
    """Adapt a network predicting ``x_start``, ``v`` or ``score`` to the eps
    interface, before guidance, with ``α_t = sqrt(ᾱ_t)``, ``σ_t = sqrt(1-ᾱ_t)``:
    ``x_start``: ``(x - α_t out) / σ_t``; ``v``: ``α_t out + σ_t x``;
    ``score``: ``-σ_t out``. ``log α_t`` is interpolated linearly over the
    timestep index, so a fractional ``t`` (DPM-Solver's grid) works and an
    integer one is an exact table read."""
    if model_type == "noise":
        return model_fn
    if model_type not in ("x_start", "v", "score"):
        raise ValueError(f"model_type must be noise|x_start|v|score, got {model_type!r}")
    log_ab = torch.from_numpy(
        (0.5 * np.log(schedule.alphas_cumprod.astype(np.float64))).astype(np.float32))

    def eps_model(x, t, cond=None):
        out = model_fn(x, t, cond)
        la = _interp_index(torch.as_tensor(t), log_ab.to(x.device))
        bshape = (x.shape[0],) + (1,) * (x.ndim - 1)
        alpha = torch.exp(la).reshape(bshape)
        sigma = torch.sqrt(-torch.expm1(2.0 * la)).reshape(bshape)
        xf, of = x.float(), out.float()
        if model_type == "x_start":
            e = (xf - alpha * of) / sigma
        elif model_type == "v":
            e = alpha * of + sigma * xf
        else:
            e = -sigma * of
        return e.to(out.dtype)

    return eps_model


def _cat_cond(a, b):
    """``[a, b]`` over the batch, entry by entry for a dict or list cond
    (``sd_tpu``'s tree concatenation)."""
    if isinstance(a, dict):
        return {k: _cat_cond(a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return [_cat_cond(u, c) for u, c in zip(a, b)]
    return torch.cat([a, b])


def make_guided_eps(model_fn: EpsModel, cond, uncond=None, guidance_scale: float = 1.0,
                    score_corrector: Optional[Callable] = None
                    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``eps(x, t)``; with guidance, one call on ``[x, x]`` with
    ``[uncond, cond]`` and ``eps_u + scale * (eps_c - eps_u)``; then
    ``score_corrector(eps, x, t, cond)`` where one is given. ``cond`` is a
    tensor, a dict of them (``LatentDiffusion.apply_model``'s) or None."""
    use_cfg = uncond is not None and guidance_scale != 1.0

    def eps(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        if use_cfg:
            out = model_fn(torch.cat([x, x]), torch.cat([t, t]), _cat_cond(uncond, cond))
            e_uncond, e_cond = out.chunk(2)
            e = e_uncond + guidance_scale * (e_cond - e_uncond)
        else:
            e = model_fn(x, t, cond)
        if score_corrector is not None:
            e = score_corrector(e, x, t, cond)
        return e

    return eps


class DDIMTables(NamedTuple):
    """Per-step solver tables over the subsetted grid (all shape [S])."""

    timesteps: np.ndarray
    alphas: np.ndarray
    alphas_prev: np.ndarray
    sqrt_one_minus_alphas: np.ndarray
    sigmas: np.ndarray


def build_ddim_tables(schedule: DiffusionSchedule, num_steps: int, eta: float = 0.0,
                      method: str = "uniform") -> DDIMTables:
    ts = make_ddim_timesteps(num_steps, schedule.num_timesteps, method)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
        schedule.alphas_cumprod.astype(np.float64), ts, eta)
    return DDIMTables(
        timesteps=ts,
        alphas=alphas.astype(np.float32),
        alphas_prev=alphas_prev.astype(np.float32),
        sqrt_one_minus_alphas=np.sqrt(1.0 - alphas).astype(np.float32),
        sigmas=sigmas.astype(np.float32),
    )


def build_original_step_tables(schedule: DiffusionSchedule, eta: float = 0.0) -> DDIMTables:
    """DDIM tables over the whole DDPM grid (``use_original_steps``): the
    raw timesteps, no +1 shift."""
    ac = schedule.alphas_cumprod.astype(np.float64)
    ac_prev = schedule.alphas_cumprod_prev.astype(np.float64)
    sigmas = eta * np.sqrt((1 - ac_prev) / (1 - ac) * (1 - ac / ac_prev))
    return DDIMTables(
        timesteps=np.arange(schedule.num_timesteps),
        alphas=ac.astype(np.float32),
        alphas_prev=ac_prev.astype(np.float32),
        sqrt_one_minus_alphas=schedule.sqrt_one_minus_alphas_cumprod,
        sigmas=sigmas.astype(np.float32),
    )


def ddim_step_from_eps(x: torch.Tensor, e_t: torch.Tensor, a_t, a_prev, sqrt_one_minus_at,
                       sigma_t=0.0, noise: Optional[torch.Tensor] = None,
                       temperature: float = 1.0, quantize_x0: Optional[Callable] = None):
    """The DDIM ``x_{t-1}`` update given eps; returns ``(x_prev, pred_x0)``.

    The scalars are float32 table entries, and the square roots are taken
    in float32, as ``sd_tpu`` takes them on device. ``noise`` enters only
    where ``sigma_t`` is not 0.
    """
    f32 = np.float32
    a_t, a_prev, sigma_t = f32(a_t), f32(a_prev), f32(sigma_t)
    pred_x0 = (x - float(f32(sqrt_one_minus_at)) * e_t) / float(np.sqrt(a_t))
    if quantize_x0 is not None:
        pred_x0 = quantize_x0(pred_x0)
    dir_xt = float(np.sqrt(f32(1.0) - a_prev - sigma_t**2)) * e_t
    x_prev = float(np.sqrt(a_prev)) * pred_x0 + dir_xt
    if sigma_t != 0:
        x_prev = x_prev + float(sigma_t) * noise * temperature
    return x_prev, pred_x0


def mask_blend(schedule: DiffusionSchedule, img: torch.Tensor, x0: torch.Tensor,
               mask: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Training-free inpainting: ``x0`` noised to level ``t`` where ``mask``
    is 1, the sample where it is 0."""
    return q_sample(schedule, x0, t, noise) * mask + (1.0 - mask) * img


def stack_intermediates(logs: List, log_every_t: int) -> Dict[str, torch.Tensor]:
    """The ``(x, pred_x0)`` of every step ``i`` with ``i % log_every_t == 0``,
    stacked: ``{"x_inter": [K, ...], "pred_x0": [K, ...]}``."""
    kept = logs[::log_every_t]
    return {"x_inter": torch.stack([x for x, _ in kept]),
            "pred_x0": torch.stack([p for _, p in kept])}
