"""Helpers for the parity tests: random parameter trees and state_dicts made
with numpy from a seed, so the same values can go into both packages."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["randomize_tree", "random_state_dict", "load_numpy_state_dict"]


def randomize_tree(tree: Mapping[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    """Replace every leaf of an ``sd_tpu`` parameter tree with float32 noise of
    its shape: kernels N(0, 1/fan_in), norm scales N(1, 0.1²), the rest
    N(0, 0.1²). Non-zero everywhere, so zero-initialized layers carry signal."""
    out: Dict[str, Any] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out[name] = randomize_tree(leaf, rng)
            continue
        shape = np.shape(leaf)
        noise = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            noise /= np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            noise = 1.0 + 0.1 * noise
        else:
            noise *= 0.1
        out[name] = noise.astype(np.float32)
    return out


def random_state_dict(module: nn.Module, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """float32 noise with the shapes of ``module.state_dict()``."""
    return {k: (0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
            for k, v in module.state_dict().items()}


def load_numpy_state_dict(module: nn.Module, sd: Mapping[str, np.ndarray]) -> nn.Module:
    """``load_state_dict`` (strict) from numpy arrays; returns the module in eval mode."""
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return module.eval()
