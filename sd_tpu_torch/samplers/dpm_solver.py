"""DPM-Solver++ (port of ``sd_tpu/samplers/dpm_solver.py``).

The data-prediction (``predict_x0``) solver over a discrete-beta schedule:
multistep at orders 1-3 with the lower-order bootstrap and final-step rules
(order 2 is what SD ships), singlestep ("DPM-Solver-fast") and the adaptive
step-size solver. The continuous time grid and every lambda/alpha/sigma
coefficient are host float64 values, rounded to float32 where they meet the
latents, as in ``sd_tpu``. The multistep solver makes ``S`` UNet
evaluations for ``S`` steps: one at each grid point but the last.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.samplers.common import EpsModel, make_guided_eps, wrap_model_output

__all__ = ["DiscreteNoiseSchedule", "dpm_solver_sample", "dpm_solver_singlestep_sample",
           "dpm_solver_adaptive_sample"]


@dataclasses.dataclass(frozen=True)
class DiscreteNoiseSchedule:
    """Host continuous-time view of a discrete-beta schedule: ``0.5 log ᾱ``
    interpolated linearly over ``t`` in (0, 1]."""

    t_array: np.ndarray          # [N] in (0, 1]
    log_alpha_array: np.ndarray  # [N]

    @classmethod
    def from_schedule(cls, schedule: DiffusionSchedule) -> "DiscreteNoiseSchedule":
        log_alphas = 0.5 * np.log(schedule.alphas_cumprod.astype(np.float64))
        t_array = np.linspace(0.0, 1.0, len(log_alphas) + 1)[1:]
        return cls(t_array=t_array, log_alpha_array=log_alphas)

    @property
    def total_N(self) -> int:
        return len(self.t_array)

    def log_alpha(self, t):
        return np.interp(t, self.t_array, self.log_alpha_array)

    def sigma(self, t):
        return np.sqrt(1.0 - np.exp(2.0 * self.log_alpha(t)))

    def lam(self, t):
        la = self.log_alpha(t)
        return la - 0.5 * np.log(1.0 - np.exp(2.0 * la))

    def inverse_lambda(self, lamb):
        """The continuous t of a half-logSNR: t interpolated over log α."""
        log_alpha = -0.5 * np.logaddexp(0.0, -2.0 * np.asarray(lamb, np.float64))
        return np.interp(log_alpha, self.log_alpha_array[::-1], self.t_array[::-1])

    def model_time(self, t):
        """Continuous t → the discrete model's timestep input, ``(t - 1/N) 1000``."""
        return (t - 1.0 / self.total_N) * 1000.0


def _setup(model_fn, schedule, cond, uncond, guidance_scale, t_start, t_end, model_type):
    model_fn = wrap_model_output(model_fn, schedule, model_type)
    ns = DiscreteNoiseSchedule.from_schedule(schedule)
    t_T = 1.0 if t_start is None else float(t_start)
    t_0 = 1.0 / ns.total_N if t_end is None else float(t_end)
    return ns, t_T, t_0, make_guided_eps(model_fn, cond, uncond, guidance_scale)


def _x0_model(eps, ns: DiscreteNoiseSchedule):
    """Data prediction ``(x - σ_t eps) / α_t`` at continuous time ``t``."""
    f32 = np.float32

    def model(x, t):
        t_vec = torch.full((x.shape[0],), float(f32(ns.model_time(t))), device=x.device)
        e = eps(x, t_vec)
        return (x - float(f32(ns.sigma(t))) * e) / float(f32(np.exp(ns.log_alpha(t))))

    return model


def dpm_solver_sample(model_fn: EpsModel, schedule: DiffusionSchedule, x_T: torch.Tensor,
                      cond: torch.Tensor, num_steps: int = 20, uncond=None,
                      guidance_scale: float = 1.0, lower_order_final: bool = True,
                      t_start: Optional[float] = None, t_end: Optional[float] = None,
                      order: int = 2, model_type: str = "noise") -> torch.Tensor:
    """Multistep DPM-Solver++ at ``order`` 1-3 over a uniform time grid of
    ``num_steps`` steps: the first steps at rising order, and with
    ``lower_order_final`` below 15 steps the last ones at falling order."""
    if order not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2 or 3, not {order}")
    if num_steps < order:
        raise ValueError(f"multistep order-{order} needs >= {order} steps")
    ns, t_T, t_0, eps = _setup(model_fn, schedule, cond, uncond, guidance_scale, t_start,
                               t_end, model_type)
    ts = np.linspace(t_T, t_0, num_steps + 1)
    lam = ns.lam(ts)
    alpha = np.exp(ns.log_alpha(ts))
    sigma = ns.sigma(ts)
    h = lam[1:] - lam[:-1]
    x0_at = _x0_model(eps, ns)
    f = lambda v: float(np.float32(v))

    def update(x, ms, i, step_order):
        """From grid i-1 to i with the newest data predictions ``ms``
        (``ms[0]`` the latest)."""
        aphi = f(alpha[i] * np.expm1(-h[i - 1]))
        out = f(sigma[i] / sigma[i - 1]) * x - aphi * ms[0]
        if step_order == 1:
            return out
        if step_order == 2:
            d1 = f(h[i - 1] / h[i - 2]) * (ms[0] - ms[1])
            return out - 0.5 * aphi * d1
        hh, r0, r1 = h[i - 1], h[i - 2] / h[i - 1], h[i - 3] / h[i - 1]
        d1_0 = f(1.0 / r0) * (ms[0] - ms[1])
        d1_1 = f(1.0 / r1) * (ms[1] - ms[2])
        d1 = d1_0 + f(r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = f(1.0 / (r0 + r1)) * (d1_0 - d1_1)
        c1 = f(alpha[i] * (np.expm1(-hh) / hh + 1.0))
        c2 = f(alpha[i] * ((np.expm1(-hh) + hh) / hh**2 - 0.5))
        return out + c1 * d1 - c2 * d2

    x = x_T
    ms = [x0_at(x, ts[0])]
    for i in range(1, order):  # lower-order bootstrap
        x = update(x, ms[::-1], i, i)
        ms.append(x0_at(x, ts[i]))
    for step in range(order, num_steps + 1):
        step_order = order
        if lower_order_final and num_steps < 15:
            step_order = min(order, num_steps + 1 - step)
        x = update(x, ms[::-1][:3], step, step_order)
        if len(ms) >= order:
            ms = ms[1:]
        if step < num_steps:
            ms.append(x0_at(x, ts[step]))
    return x


def _singlestep_orders(num_steps: int, order: int) -> list:
    """The orders whose sum is ``num_steps`` (DPM-Solver-fast's schedule)."""
    if order == 3:
        k = num_steps // 3 + 1
        if num_steps % 3 == 0:
            return [3] * (k - 2) + [2, 1]
        return [3] * (k - 1) + ([1] if num_steps % 3 == 1 else [2])
    if order == 2:
        k = num_steps // 2 if num_steps % 2 == 0 else num_steps // 2 + 1
        return [2] * k if num_steps % 2 == 0 else [2] * (k - 1) + [1]
    return [1] * num_steps


def dpm_solver_singlestep_sample(model_fn: EpsModel, schedule: DiffusionSchedule,
                                 x_T: torch.Tensor, cond: torch.Tensor, num_steps: int = 20,
                                 order: int = 3, uncond=None, guidance_scale: float = 1.0,
                                 t_start: Optional[float] = None,
                                 t_end: Optional[float] = None,
                                 model_type: str = "noise") -> torch.Tensor:
    """Singlestep DPM-Solver++: steps of orders up to ``order`` whose model
    evaluations sum to ``num_steps``, each intermediate time placed by an
    even split of lambda."""
    if order not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2 or 3, not {order}")
    ns, t_T, t_0, eps = _setup(model_fn, schedule, cond, uncond, guidance_scale, t_start,
                               t_end, model_type)
    orders = _singlestep_orders(num_steps, order)
    outer = np.linspace(t_T, t_0, num_steps + 1)[np.cumsum([0] + orders)]
    model = _x0_model(eps, ns)
    f = lambda v: float(np.float32(v))

    x = x_T
    for i, o in enumerate(orders):
        s, t = float(outer[i]), float(outer[i + 1])
        lam_s = ns.lam(s)
        h = ns.lam(t) - lam_s
        sig_s, sig_t = ns.sigma(s), ns.sigma(t)
        alpha_t = np.exp(ns.log_alpha(t))
        m_s = model(x, s)
        if o == 1:
            x = f(sig_t / sig_s) * x - f(alpha_t * np.expm1(-h)) * m_s
            continue
        lam_inner = ns.lam(np.linspace(s, t, o + 1))
        r1 = float((lam_inner[1] - lam_s) / h)
        s1 = float(ns.inverse_lambda(lam_s + r1 * h))
        x_s1 = (f(ns.sigma(s1) / sig_s) * x
                - f(np.exp(ns.log_alpha(s1)) * np.expm1(-r1 * h)) * m_s)
        m_s1 = model(x_s1, s1)
        phi_1 = np.expm1(-h)
        if o == 2:
            x = (f(sig_t / sig_s) * x - f(alpha_t * phi_1) * m_s
                 - f(0.5 / r1) * f(alpha_t * phi_1) * (m_s1 - m_s))
            continue
        r2 = float((lam_inner[2] - lam_s) / h)
        s2 = float(ns.inverse_lambda(lam_s + r2 * h))
        alpha_s2 = np.exp(ns.log_alpha(s2))
        phi_12 = np.expm1(-r2 * h)
        phi_22 = np.expm1(-r2 * h) / (r2 * h) + 1.0
        phi_2 = phi_1 / h + 1.0
        x_s2 = (f(ns.sigma(s2) / sig_s) * x - f(alpha_s2 * phi_12) * m_s
                + f(r2 / r1) * f(alpha_s2 * phi_22) * (m_s1 - m_s))
        m_s2 = model(x_s2, s2)
        x = (f(sig_t / sig_s) * x - f(alpha_t * phi_1) * m_s
             + f(1.0 / r2) * f(alpha_t * phi_2) * (m_s2 - m_s))
    return x


def dpm_solver_adaptive_sample(model_fn: EpsModel, schedule: DiffusionSchedule,
                               x_T: torch.Tensor, cond: torch.Tensor, order: int = 2,
                               uncond=None, guidance_scale: float = 1.0,
                               t_start: Optional[float] = None, t_end: Optional[float] = None,
                               h_init: float = 0.05, atol: float = 0.0078, rtol: float = 0.05,
                               theta: float = 0.9, t_err: float = 1e-5, max_nfe: int = 1200,
                               model_type: str = "noise") -> torch.Tensor:
    """Adaptive step-size DPM-Solver++: each step pairs a lower- and a
    higher-order singlestep update (orders 1 and 2, or 2 and 3, sharing
    their evaluations), accepts where the error norm
    ``max_b rms((x_hi - x_lo) / delta)`` is at most 1, and sets the next
    lambda step to ``theta h E^(-1/order)``, clipped at the end. The norm is
    read back to the host once a step; ``max_nfe`` bounds the loop."""
    if order not in (2, 3):
        raise ValueError(f"order must be 2 or 3, not {order}")
    ns, t_T, t_0, eps = _setup(model_fn, schedule, cond, uncond, guidance_scale, t_start,
                               t_end, model_type)
    model = _x0_model(eps, ns)
    f = lambda v: float(np.float32(v))
    sigma = ns.sigma
    alpha = lambda t: np.exp(ns.log_alpha(t))

    def solver1(x, s, t, m_s):
        return f(sigma(t) / sigma(s)) * x - f(alpha(t) * np.expm1(ns.lam(s) - ns.lam(t))) * m_s

    def solver2(x, s, t, r1, m_s):
        h = ns.lam(t) - ns.lam(s)
        s1 = float(ns.inverse_lambda(ns.lam(s) + r1 * h))
        x_s1 = f(sigma(s1) / sigma(s)) * x - f(alpha(s1) * np.expm1(-r1 * h)) * m_s
        m_s1 = model(x_s1, s1)
        phi_1 = np.expm1(-h)
        x_t = (f(sigma(t) / sigma(s)) * x - f(alpha(t) * phi_1) * m_s
               - f((0.5 / r1) * alpha(t) * phi_1) * (m_s1 - m_s))
        return x_t, m_s1, s1

    def solver3(x, s, t, r1, r2, m_s, m_s1):
        h = ns.lam(t) - ns.lam(s)
        s2 = float(ns.inverse_lambda(ns.lam(s) + r2 * h))
        phi_12 = np.expm1(-r2 * h)
        phi_22 = np.expm1(-r2 * h) / (r2 * h) + 1.0
        x_s2 = (f(sigma(s2) / sigma(s)) * x - f(alpha(s2) * phi_12) * m_s
                + f((r2 / r1) * alpha(s2) * phi_22) * (m_s1 - m_s))
        m_s2 = model(x_s2, s2)
        phi_1 = np.expm1(-h)
        phi_2 = phi_1 / h + 1.0
        return (f(sigma(t) / sigma(s)) * x - f(alpha(t) * phi_1) * m_s
                + f((1.0 / r2) * alpha(t) * phi_2) * (m_s2 - m_s))

    lambda_0 = ns.lam(t_0)
    x = x_prev = x_T
    s, h, nfe = t_T, h_init, 0
    b = x.shape[0]
    while abs(s - t_0) > t_err and nfe < max_nfe:
        t = float(ns.inverse_lambda(ns.lam(s) + h))
        m_s = model(x, s)
        if order == 2:
            x_lower = solver1(x, s, t, m_s)
            x_higher, _, _ = solver2(x, s, t, 0.5, m_s)
        else:
            x_lower, m_s1, _ = solver2(x, s, t, 1.0 / 3.0, m_s)
            x_higher = solver3(x, s, t, 1.0 / 3.0, 2.0 / 3.0, m_s, m_s1)
        delta = torch.clamp(rtol * torch.maximum(x_lower.abs(), x_prev.abs()), min=atol)
        err = ((x_higher - x_lower) / delta).float().reshape(b, -1)
        e_norm = float(err.square().mean(dim=-1).sqrt().max())
        if e_norm <= 1.0:
            x, s, x_prev = x_higher, t, x_lower
        grow = np.inf if e_norm == 0 else e_norm ** (-1.0 / order)
        h = min(theta * h * grow, lambda_0 - ns.lam(s))
        nfe += order
    return x
