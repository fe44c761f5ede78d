"""EMA of the trainable weights (port of ``sd_tpu/training/ema.py``).

The shadow is an fp32 copy of a ``state_dict``; each update moves it toward
the live weights with the warmup-adjusted decay ``min(decay, (1+n)/(10+n))``
of the reference's ``LitEma``. Updates are in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import torch

__all__ = ["EmaState", "ema_init", "ema_update"]


@dataclasses.dataclass
class EmaState:
    shadow: Dict[str, torch.Tensor]
    num_updates: int = 0
    decay: float = 0.9999

    def state_dict(self) -> dict:
        return {"shadow": self.shadow, "num_updates": self.num_updates, "decay": self.decay}

    def load_state_dict(self, sd: Mapping) -> None:
        for name, value in sd["shadow"].items():
            self.shadow[name].copy_(value)
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
