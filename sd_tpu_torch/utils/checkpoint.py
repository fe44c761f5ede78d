"""Training checkpoints (port of ``save_last``, ``latest_checkpoint`` and
restore from ``sd_tpu/utils/checkpoint.py``).

A checkpoint is one ``torch.save`` file: the step, the UNet ``state_dict``,
the optimizer, the LR schedule and the EMA shadow, and metadata (seed,
scale_factor, step). The frozen stages are not in it: a resumed run rebuilds
them from the config and the seed. ``<ckpt_dir>/last.pt`` is the resume
entry; monitored top-k retention is not ported.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

__all__ = ["save_last", "latest_checkpoint", "restore_checkpoint"]


def save_last(ckpt_dir: str, state, metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write ``state.state_dict()`` and ``metadata`` (plus the step) to
    ``<ckpt_dir>/last.pt``, atomically; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "last.pt")
    tmp = f"{path}.tmp{os.getpid()}"
    meta = {**(metadata or {}), "step": int(state.step)}
    torch.save({"state": state.state_dict(), "meta": meta}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """``<ckpt_dir>/last.pt`` if present, else None."""
    last = os.path.join(ckpt_dir, "last.pt")
    return last if os.path.isfile(last) else None


def restore_checkpoint(path: str, state) -> Dict[str, Any]:
    """Load a checkpoint into ``state`` (in place); returns its metadata."""
    blob = torch.load(path, map_location=next(state.unet.parameters()).device,
                      weights_only=True)
    state.load_state_dict(blob["state"])
    return blob["meta"]
