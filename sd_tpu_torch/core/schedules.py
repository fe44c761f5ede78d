"""Diffusion schedule tables (host numpy) and the timestep embedding.

Port of ``sd_tpu/core/schedules.py``: the beta schedules, the DDIM
timestep subsets (``uniform`` and ``quad``) and the :class:`DiffusionSchedule`
buffers are computed once on the host in float64 and kept as float32 numpy
arrays, exactly as there; the samplers read them as Python scalars.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "make_beta_schedule",
    "make_ddim_timesteps",
    "make_ddim_sampling_parameters",
    "DiffusionSchedule",
    "q_sample",
    "predict_start_from_noise",
    "q_posterior",
    "timestep_embedding",
]


def make_beta_schedule(schedule: str, n_timestep: int, linear_start: float = 1e-4,
                       linear_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """Beta schedule table (float64). ``linear`` is the SD schedule: linspace
    in sqrt-beta space, squared."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], a_min=0, a_max=0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


def make_ddim_timesteps(num_ddim_timesteps: int, num_ddpm_timesteps: int,
                        method: str = "uniform") -> np.ndarray:
    """The DDIM subset of the DDPM timesteps, shifted by +1 and clamped to
    T-1: every ``T // S``-th step (``uniform``) or a quadratic spacing over
    the first 80% of the grid (``quad``)."""
    if method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif method == "quad":
        ddim_timesteps = (np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8),
                                      num_ddim_timesteps) ** 2).astype(int)
    else:
        raise NotImplementedError(f'There is no ddim discretization method called "{method}"')
    return np.minimum(ddim_timesteps + 1, num_ddpm_timesteps - 1)


def make_ddim_sampling_parameters(alphacums: np.ndarray, ddim_timesteps: np.ndarray,
                                  eta: float = 0.0
                                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-step (sigma, alpha, alpha_prev) tables for DDIM at ``eta``."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The DDPM buffers as immutable float32 host arrays; build with :meth:`create`."""

    num_timesteps: int
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    log_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    lvlb_weights: np.ndarray
    linear_start: float = 1e-4
    linear_end: float = 2e-2

    @classmethod
    def create(cls, timesteps: int = 1000, beta_schedule: str = "linear",
               linear_start: float = 1e-4, linear_end: float = 2e-2,
               cosine_s: float = 8e-3, given_betas: Optional[np.ndarray] = None,
               v_posterior: float = 0.0, parameterization: str = "eps"
               ) -> "DiffusionSchedule":
        if given_betas is not None:
            betas = np.asarray(given_betas, dtype=np.float64)
        else:
            betas = make_beta_schedule(beta_schedule, timesteps, linear_start=linear_start,
                                       linear_end=linear_end, cosine_s=cosine_s)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        (n,) = betas.shape
        posterior_variance = (1 - v_posterior) * betas * (1.0 - alphas_cumprod_prev) / (
            1.0 - alphas_cumprod) + v_posterior * betas
        if parameterization == "eps":
            with np.errstate(divide="ignore"):
                lvlb_weights = betas**2 / (
                    2 * posterior_variance * alphas * (1 - alphas_cumprod))
        elif parameterization == "x0":
            lvlb_weights = 0.5 * np.sqrt(alphas_cumprod) / (2.0 * 1 - alphas_cumprod)
        else:
            raise NotImplementedError(f"parameterization {parameterization} not supported")
        lvlb_weights = np.array(lvlb_weights)
        lvlb_weights[0] = lvlb_weights[1]
        if np.isnan(lvlb_weights).any():
            raise ValueError("lvlb_weights has NaN")
        return cls(
            num_timesteps=int(n),
            betas=_f32(betas),
            alphas_cumprod=_f32(alphas_cumprod),
            alphas_cumprod_prev=_f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod=_f32(np.sqrt(alphas_cumprod)),
            sqrt_one_minus_alphas_cumprod=_f32(np.sqrt(1.0 - alphas_cumprod)),
            log_one_minus_alphas_cumprod=_f32(np.log(1.0 - alphas_cumprod)),
            sqrt_recip_alphas_cumprod=_f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=_f32(np.sqrt(1.0 / alphas_cumprod - 1)),
            posterior_variance=_f32(posterior_variance),
            posterior_log_variance_clipped=_f32(np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=_f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=_f32((1.0 - alphas_cumprod_prev) * np.sqrt(alphas)
                                      / (1.0 - alphas_cumprod)),
            lvlb_weights=_f32(lvlb_weights),
            linear_start=linear_start,
            linear_end=linear_end,
        )


def _extract(table: np.ndarray, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``table[t]`` for timesteps ``t [B]``, shaped to broadcast against ``like``."""
    out = torch.as_tensor(table, device=like.device)[t.long()].to(like.dtype)
    return out.reshape((-1,) + (1,) * (like.ndim - 1))


def q_sample(schedule: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion ``sqrt(ᾱ_t) x0 + sqrt(1 - ᾱ_t) noise`` at integer
    timesteps ``t [B]`` (``x0`` and ``noise`` ``[B, ...]``)."""
    return (_extract(schedule.sqrt_alphas_cumprod, t, x0) * x0
            + _extract(schedule.sqrt_one_minus_alphas_cumprod, t, x0) * noise)


def predict_start_from_noise(schedule: DiffusionSchedule, x_t: torch.Tensor, t: torch.Tensor,
                             noise: torch.Tensor) -> torch.Tensor:
    """The x0 estimate ``sqrt(1/ᾱ_t) x_t - sqrt(1/ᾱ_t - 1) eps``."""
    return (_extract(schedule.sqrt_recip_alphas_cumprod, t, x_t) * x_t
            - _extract(schedule.sqrt_recipm1_alphas_cumprod, t, x_t) * noise)


def q_posterior(schedule: DiffusionSchedule, x_start: torch.Tensor, x_t: torch.Tensor,
                t: torch.Tensor):
    """The Gaussian posterior q(x_{t-1} | x_t, x_0): ``(mean, variance,
    log_variance_clipped)``, the last two shaped to broadcast."""
    mean = (_extract(schedule.posterior_mean_coef1, t, x_t) * x_start
            + _extract(schedule.posterior_mean_coef2, t, x_t) * x_t)
    return (mean, _extract(schedule.posterior_variance, t, x_t),
            _extract(schedule.posterior_log_variance_clipped, t, x_t))


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    """Sinusoidal embeddings, ``[N] -> [N, dim]`` float32, (cos, sin) order.

    The frequency table is computed on the host in float64 and rounded to
    float32 once, so every device uses the same table; ``sd_tpu`` computes it
    with XLA's float32 ``exp``, which differs from it by at most one ulp.
    """
    half = dim // 2
    freqs = np.exp(-math.log(max_period) * np.arange(half, dtype=np.float64) / half)
    freqs = torch.from_numpy(freqs.astype(np.float32)).to(timesteps.device)
    args = timesteps[:, None].float() * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding
