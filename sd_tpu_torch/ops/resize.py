"""Image resizes as ``jax.image.resize`` computes them, for the port's
tensors (``sd_tpu`` resizes with ``jax.image.resize``: the safety checker's
input, ``SpatialRescaler``, the super-resolution pipeline's conditioning).

``jax.image.resize`` is separable: along each axis whose size changes, a
weight matrix built by its scale-and-translate rule (``compute_weight_mat``
at translation 0): the sample positions ``(i + 0.5) · in/out − 0.5``, the
kernel (Keys' cubic with a = −0.5 for "bicubic", the triangle for
"bilinear") widened by the downscale factor where it shrinks (antialiasing,
on by default), each output's weights normalised to sum to 1, and outputs
whose position lies outside the input zeroed. Its "nearest" takes input
``floor((i + 0.5) · in/out)`` computed in float32. This is not
``F.interpolate``: its bicubic uses a = −0.75 and it does not antialias.
The matrices are built on the host in float64 and cached per size; on the
device a resize is two matrix products in float32.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

__all__ = ["resize_weights", "nearest_indices", "resize", "KERNELS"]


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


# jax.image.resize's method names → the kernel of its weights ("nearest" apart)
KERNELS = {"linear": "triangle", "bilinear": "triangle", "trilinear": "triangle",
           "triangle": "triangle", "cubic": "cubic", "bicubic": "cubic", "tricubic": "cubic"}
_FILL = {"triangle": _triangle, "cubic": _keys_cubic}


@lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int, kernel: str = "cubic",
                   antialias: bool = True) -> np.ndarray:
    """``[out_size, in_size]`` float64: ``jax.image.resize``'s weights along
    one axis (``compute_weight_mat`` at translation 0), transposed;
    ``kernel`` is "cubic" or "triangle"."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    w = _FILL[kernel](np.abs(sample_f[:, None] - np.arange(in_size)[None, :]) / kernel_scale)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[:, None], w, 0.0)


@lru_cache(maxsize=64)
def nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """``jax.image.resize``'s "nearest" along one axis: the input index of
    each output, from float32 arithmetic as JAX computes it."""
    pos = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(in_size)
    return np.floor(pos / np.float32(out_size)).astype(np.int64)


def resize(x: torch.Tensor, size: Tuple[int, int], method: str = "bicubic",
           antialias: bool = True) -> torch.Tensor:
    """``[B, C, H, W]`` → ``[B, C, size[0], size[1]]`` as ``jax.image.resize``
    gives it for ``method`` ("nearest", or a name of :data:`KERNELS`), in
    the dtype of ``x`` (computed in float32). An axis whose size does not
    change is left as it is, as JAX leaves it."""
    h, w = x.shape[-2:]
    oh, ow = size
    if method == "nearest":
        if oh != h:
            x = x[..., torch.from_numpy(nearest_indices(h, oh)).to(x.device), :]
        if ow != w:
            x = x[..., torch.from_numpy(nearest_indices(w, ow)).to(x.device)]
        return x
    if method not in KERNELS:
        raise ValueError(f"resize method {method!r}: expected nearest or one of "
                         f"{sorted(KERNELS)}")
    kernel = KERNELS[method]
    y = x.float()
    with torch.autocast(x.device.type, enabled=False):
        if oh != h:
            wh = resize_weights(h, oh, kernel, antialias)
            y = torch.matmul(torch.from_numpy(wh).to(x.device, torch.float32), y)
        if ow != w:
            ww = resize_weights(w, ow, kernel, antialias)
            y = torch.matmul(y, torch.from_numpy(ww).to(x.device, torch.float32).t())
    return y.to(x.dtype)
