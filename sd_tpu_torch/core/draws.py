"""Random draws that do not depend on the number of data-parallel ranks.

A :class:`RowDraws` stands where a ``torch.Generator`` goes: each draw is
made for the global batch from the one generator, in the order one process
makes it, and the rank gets its rows of it. The samplers
(``samplers/common.py``), the posterior sample (``core/distributions.py``)
and the LDM train step (``training/diffusion_loss.py``) draw through
:func:`draw`, which takes either.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["RowDraws", "draw"]


@dataclasses.dataclass(frozen=True)
class RowDraws:
    """Draws of ``generator`` made for the global batch, ``count`` times the
    rows asked for, of which rank ``index``'s rows are returned: the block
    ``[index·b, (index+1)·b)`` (where ``P("data")`` places a rank's rows), or
    with ``strided`` the rows ``index::count`` (the loader's shard of a
    global batch, ``data/base.py``). So a rank draws its rows of what one
    process draws for the whole batch, in the same order of calls."""

    generator: torch.Generator
    index: int
    count: int
    strided: bool = False

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def draw(self, fn: Callable, shape, *args, **kwargs) -> torch.Tensor:
        """``fn(*args, global shape, generator=..., **kwargs)``'s rows of this rank."""
        b = shape[0]
        full = fn(*args, (b * self.count,) + tuple(shape[1:]), generator=self.generator,
                  **kwargs)
        if self.strided:
            return full[self.index::self.count]
        return full[self.index * b:(self.index + 1) * b]


def draw(fn: Callable, shape, generator, where, *args, **kwargs) -> torch.Tensor:
    """``fn(*args, shape, generator=generator, device=where, **kwargs)``,
    the rank's rows of it where ``generator`` is a :class:`RowDraws`."""
    if isinstance(generator, RowDraws):
        return generator.draw(fn, shape, *args, device=where, **kwargs)
    return fn(*args, shape, generator=generator, device=where, **kwargs)


