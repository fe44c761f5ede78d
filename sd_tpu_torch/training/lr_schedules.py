"""LR multiplier schedules as functions of the step (port of
``sd_tpu/training/lr_schedules.py``).

Warmup + cosine, multi-cycle warmup + cosine, and multi-cycle warmup +
linear (SD's ``LambdaLinearScheduler``). Each returns ``f(step) -> float``,
the multiplier of the base LR, for ``torch.optim.lr_scheduler.LambdaLR``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

__all__ = ["lambda_warmup_cosine", "lambda_warmup_cosine2", "lambda_linear"]

Schedule = Callable[[int], float]


def lambda_warmup_cosine(warm_up_steps, lr_min, lr_max, lr_start, max_decay_steps) -> Schedule:
    """Warmup then cosine decay."""

    def schedule(n: int) -> float:
        if n < warm_up_steps:
            return (lr_max - lr_start) / warm_up_steps * n + lr_start
        t = min((n - warm_up_steps) / (max_decay_steps - warm_up_steps), 1.0)
        return lr_min + 0.5 * (lr_max - lr_min) * (1 + math.cos(t * math.pi))

    return schedule


def _multi_cycle(warm_up_steps: Sequence[float], f_min: Sequence[float],
                 f_max: Sequence[float], f_start: Sequence[float],
                 cycle_lengths: Sequence[float], tail) -> Schedule:
    cum = np.cumsum(np.concatenate([[0.0], np.asarray(cycle_lengths, np.float64)]))

    def schedule(step: int) -> float:
        c = int(np.sum(step > cum[1:-1]))  # the cycle that holds this step
        n = step - cum[c]
        wu, fst, fmax = warm_up_steps[c], f_start[c], f_max[c]
        if n < wu:
            return float((fmax - fst) / wu * n + fst)
        return float(tail(n, wu, f_min[c], fmax, cycle_lengths[c]))

    return schedule


def lambda_warmup_cosine2(warm_up_steps, f_min, f_max, f_start, cycle_lengths) -> Schedule:
    """Multi-cycle warmup + cosine."""

    def tail(n, wu, fmin, fmax, cl):
        t = min((n - wu) / (cl - wu), 1.0)
        return fmin + 0.5 * (fmax - fmin) * (1 + math.cos(t * math.pi))

    return _multi_cycle(warm_up_steps, f_min, f_max, f_start, cycle_lengths, tail)


def lambda_linear(warm_up_steps, f_min, f_max, f_start, cycle_lengths) -> Schedule:
    """Multi-cycle warmup + linear decay, SD's scheduler."""

    def tail(n, wu, fmin, fmax, cl):
        return fmin + (fmax - fmin) * (cl - n) / cl

    return _multi_cycle(warm_up_steps, f_min, f_max, f_start, cycle_lengths, tail)
