"""EMA of the trainable weights (port of ``sd_tpu/training/ema.py``).

The shadow is an fp32 copy of a ``state_dict``; each update moves it toward
the live weights with the warmup-adjusted decay ``min(decay, (1+n)/(10+n))``
of the reference's ``LitEma``. Updates are in place. :func:`ema_scope`
swaps the shadow into named parameters for a while (the reference's
``ema_scope``), by pointing them at the shadow's storage.

Under ZeRO-1 (``parallel/mesh.py::zero_state_sharding``) the shadow is
partitioned as the optimizer's moments are: :meth:`EmaState.shard` keeps
the owned tensors alone, each rank updates its own, and
:meth:`EmaState.full_shadow` (every rank calls it) broadcasts each tensor
from its owner, for :func:`ema_scope` and for the checkpoint, whose layout
is the single-process one.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Mapping, Optional

import torch
import torch.distributed as dist

__all__ = ["EmaState", "ema_init", "ema_update", "ema_scope"]


@dataclasses.dataclass
class EmaState:
    """The shadow (this rank's tensors under ZeRO-1), the update count and
    the decay; once :meth:`shard` partitioned the shadow, ``owners`` maps
    every name to its owning rank in ``group`` and ``shapes`` to its shape
    (on ``device``)."""

    shadow: Dict[str, torch.Tensor]
    num_updates: int = 0
    decay: float = 0.9999
    owners: Optional[Dict[str, int]] = None
    shapes: Optional[Dict[str, torch.Size]] = None
    device: Optional[torch.device] = None
    group: Any = None

    def shard(self, owners: Mapping[str, int], group=None) -> None:
        """Keep the shadow of the names this rank owns (``owners``: name →
        rank in ``group``)."""
        me = dist.get_rank(group)
        self.owners, self.group = dict(owners), group
        self.shapes = {n: s.shape for n, s in self.shadow.items()}
        self.device = next(iter(self.shadow.values())).device
        self.shadow = {n: s for n, s in self.shadow.items() if self.owners[n] == me}

    def full_shadow(self) -> Dict[str, torch.Tensor]:
        """Every name's shadow on every rank (a collective under ZeRO-1:
        one broadcast a tensor, in name order, from its owner)."""
        if self.owners is None:
            return self.shadow
        me = dist.get_rank(self.group)
        full = {}
        for name, owner in sorted(self.owners.items()):
            t = self.shadow.get(name) if owner == me else torch.empty(
                self.shapes[name], dtype=torch.float32, device=self.device)
            src = dist.get_global_rank(self.group or dist.group.WORLD, owner)
            dist.broadcast(t, src=src, group=self.group)
            full[name] = t
        return full

    def state_dict(self) -> dict:
        return {"shadow": self.full_shadow(), "num_updates": self.num_updates,
                "decay": self.decay}

    def load_state_dict(self, sd: Mapping) -> None:
        """From the single-process layout (the whole shadow): a sharded
        shadow takes its own names."""
        for name, s in self.shadow.items():
            s.copy_(sd["shadow"][name])
        self.num_updates = int(sd["num_updates"])
        self.decay = float(sd["decay"])


def ema_init(params: Mapping[str, torch.Tensor], decay: float = 0.9999) -> EmaState:
    """A shadow holding fp32 copies of ``params`` (name → tensor)."""
    shadow = {name: p.detach().to(torch.float32, copy=True) for name, p in params.items()}
    return EmaState(shadow=shadow, decay=decay)


@torch.no_grad()
def ema_update(state: EmaState, params: Mapping[str, torch.Tensor]) -> EmaState:
    """``shadow -= (1 - decay) (shadow - params)``, in place; returns ``state``."""
    state.num_updates += 1
    n = state.num_updates
    decay = min(state.decay, (1.0 + n) / (10.0 + n))
    for name, s in state.shadow.items():
        s.sub_((1.0 - decay) * (s - params[name].float()))
    return state


def _swap_in(params: Mapping[str, torch.nn.Parameter],
             data: Mapping[str, torch.Tensor]) -> None:
    """Points each parameter at ``data[name]``'s storage, without a copy.
    Each parameter's version is bumped, so that caches keyed by a weight's
    (pointer, version) miss, and autocast's cached casts, which are keyed by
    the parameter and outlive a change of its values, are dropped."""
    for name, p in params.items():
        p.data = data[name]
        torch.autograd.graph.increment_version(p)
    torch.clear_autocast_cache()


@contextlib.contextmanager
def ema_scope(state: EmaState, params: Mapping[str, torch.nn.Parameter]) -> Iterator[None]:
    """Within the block the parameters ``params`` (their names in the
    shadow → parameter) hold the shadow's values; afterwards they hold their
    own again, bit for bit. They share the shadow's storage meanwhile (no
    copy), so they must have its dtype and shape, and the block must not
    write to them. Under ZeRO-1 every rank enters it (the shadow is
    gathered first)."""
    shadow = state.full_shadow()
    for name, p in params.items():
        s = shadow[name]
        if (s.dtype, s.shape, s.device) != (p.dtype, p.shape, p.device):
            raise ValueError(f"ema_scope: {name} is {p.dtype} {tuple(p.shape)} on {p.device}, "
                             f"its shadow {s.dtype} {tuple(s.shape)} on {s.device}")
    own = {name: p.data for name, p in params.items()}
    _swap_in(params, shadow)
    try:
        yield
    finally:
        _swap_in(params, own)
