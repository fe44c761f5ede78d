"""Data-parallel sampling over the ranks of a mesh's ``data`` dim (port of
``sd_tpu/parallel/sharded_sampling.py``).

``sd_tpu`` jits the sampler with the batch sharded over its mesh and GSPMD
partitions every step, with no collective in the loop. Here each rank
samples its own rows and the results are gathered once, at the end. The
draws do not depend on the number of ranks: every rank draws the GLOBAL
``x_T`` from the one generator and takes its rows, and the sampler's own
draws (DDIM's noise at eta > 0, the blend's, the dropout's) come through a
:class:`~sd_tpu_torch.samplers.common.RowDraws`, which draws for the whole
batch and hands the rank its rows. So N ranks return what one process
returns for the same generator.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.parallel.mesh import all_gather_rows, axis_info, take_rows
from sd_tpu_torch.samplers.common import RowDraws, randn

__all__ = ["sharded_sample"]


def sharded_sample(mesh, sampler_fn: Callable, model_fn, schedule: DiffusionSchedule, shape,
                   cond, generator: Optional[torch.Generator] = None, uncond=None,
                   x_T: Optional[torch.Tensor] = None, **sampler_kwargs) -> torch.Tensor:
    """``sampler_fn`` (``ddim_sample``, ``plms_sample``, ``dpm_solver_sample``)
    on this rank's block of the batch; returns the whole batch's result,
    ``shape`` (NCHW, the samplers' layout), on every rank, in rank order.

    ``cond`` and ``uncond`` (tensors or dicts of them, with the global
    batch's rows) are sharded alongside. ``x_T`` (the global one) or a draw
    of ``shape`` from ``generator``, which the sampler's draws come from
    too, on the generator's device. ``shape[0]`` must divide by the number of
    ranks (``ValueError``)."""
    group, index, count = axis_info(mesh, "data")
    if shape[0] % count:
        raise ValueError(f"batch {shape[0]} does not divide over the {count} ranks of the "
                         f"data dim")
    if x_T is None:
        if generator is None:
            raise ValueError("sharded_sample: give x_T or a generator")
        x_T = randn(shape, generator, generator.device)
    elif tuple(x_T.shape) != tuple(shape):
        raise ValueError(f"x_T has shape {tuple(x_T.shape)}, expected {tuple(shape)}")
    if generator is not None:  # DPM-Solver++ draws nothing and takes no generator
        sampler_kwargs["generator"] = (generator if count == 1
                                       else RowDraws(generator, index, count))
    result = sampler_fn(model_fn, schedule, take_rows(x_T, index, count),
                        take_rows(cond, index, count), uncond=take_rows(uncond, index, count),
                        **sampler_kwargs)
    out = result[0] if isinstance(result, tuple) else result
    return all_gather_rows(out.contiguous(), group)
