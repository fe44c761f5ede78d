"""Tiled (sliding-window) application of a model over a large canvas
(port of ``sd_tpu/pipelines/tiled.py``, the reference's
``split_input_params`` fold/unfold).

Overlapping ``ks x ks`` patches on a grid of ``stride``, the last patch of
each axis right-aligned so that the whole canvas is covered
(:func:`_grid_starts`); the patches run as one batched call of the model
(batch-major: element b's patches are contiguous), and the outputs are
stitched by an overlap-add weighted by each pixel's distance to its patch's
border (:func:`tiling_weights`), normalised by the summed weights. Tensors
are NCHW (patches ``[B, P, C, ks, ks]``); the overlap-add sums in float32
and returns the patches' dtype. With a ``mesh`` (``parallel/mesh.py``) the
flattened ``[B·P]`` patch axis is sharded over the ranks of its
``mesh_axis``: each rank runs ``fn`` on its block of patches, the last
block padded with zero patches where the ranks do not divide B·P (as GSPMD
pads the last shard), the outputs are gathered in rank order and the
padding dropped before the fold.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

__all__ = ["tiling_weights", "extract_patches", "fold_patches", "tiled_apply"]


def _grid_starts(size: int, ks: int, stride: int) -> np.ndarray:
    """Patch starts covering [0, size); the last one right-aligned."""
    if size <= ks:
        return np.array([0])
    starts = list(range(0, size - ks + 1, stride))
    if starts[-1] != size - ks:
        starts.append(size - ks)
    return np.asarray(starts)


def tiling_weights(ks: int, clip_min: float = 0.01, clip_max: float = 0.5) -> np.ndarray:
    """``[ks, ks]`` float32: each pixel's L-inf distance to the patch border
    over ``ks``, clipped to [clip_min, clip_max] (the reference's
    ``delta_border`` and ``get_weighting``)."""
    ys = np.arange(ks) + 0.5
    d = np.minimum(ys, ks - ys) / ks
    return np.clip(np.minimum(d[:, None], d[None, :]), clip_min, clip_max).astype(np.float32)


def extract_patches(x: torch.Tensor, ks: int, stride: int
                    ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """``[B, C, H, W]`` → ``([B, P, C, ks, ks], starts_y, starts_x)``, the
    patches row by row."""
    sy = _grid_starts(x.shape[2], ks, stride)
    sx = _grid_starts(x.shape[3], ks, stride)
    patches = torch.stack([x[:, :, y:y + ks, xx:xx + ks] for y in sy for xx in sx], dim=1)
    return patches, sy, sx


def fold_patches(patches: torch.Tensor, out_hw: Tuple[int, int], ks: int,
                 sy: Sequence[int], sx: Sequence[int], clip_min: float = 0.01,
                 clip_max: float = 0.5) -> torch.Tensor:
    """The weighted overlap-add of ``[B, P, C, ks, ks]`` patches at the grid
    ``sy`` x ``sx`` into ``[B, C, H, W]``, normalised by the summed weights."""
    b, _, c = patches.shape[:3]
    h, w = out_hw
    dev = patches.device
    weight = torch.from_numpy(tiling_weights(ks, clip_min, clip_max)).to(dev)
    out = torch.zeros((b, c, h, w), dtype=torch.float32, device=dev)
    norm = torch.zeros((h, w), dtype=torch.float32, device=dev)
    i = 0
    for y in sy:
        for x in sx:
            y, x = int(y), int(x)
            out[:, :, y:y + ks, x:x + ks] += patches[:, i].float() * weight
            norm[y:y + ks, x:x + ks] += weight
            i += 1
    return (out / norm).to(patches.dtype)


def _sharded(fn: Callable[[torch.Tensor], torch.Tensor], flat: torch.Tensor, mesh,
             mesh_axis: str) -> torch.Tensor:
    """``fn`` on this rank's block of ``flat``'s rows (zero rows pad the
    last block), every rank's outputs gathered in rank order, the padding
    dropped."""
    from sd_tpu_torch.parallel.mesh import all_gather_rows, axis_info

    group, index, count = axis_info(mesh, mesh_axis)
    n = flat.shape[0]
    per = -(-n // count)
    padded = torch.cat([flat, flat.new_zeros((per * count - n,) + flat.shape[1:])])
    out = fn(padded[index * per:(index + 1) * per])
    return all_gather_rows(out.contiguous(), group)[:n]


def tiled_apply(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, ks: int = 128,
                stride: int = 64, out_scale: float = 1, clip_min: float = 0.01,
                clip_max: float = 0.5, mesh=None, mesh_axis: str = "data") -> torch.Tensor:
    """``fn`` (``[N, C, ks, ks]`` → ``[N, C', ks·s, ks·s]``) over the
    overlapping tiles of ``x [B, C, H, W]`` in one call (one a rank with a
    ``mesh``), stitched to ``[B, C', H·s, W·s]`` for ``s = out_scale``:
    above 1 for a decoder, below 1 for an encoder (``ks``, the starts and the
    canvas must then scale to whole numbers)."""
    b, _, h, w = x.shape
    patches, sy, sx = extract_patches(x, ks, stride)
    p = patches.shape[1]
    flat = patches.reshape((b * p,) + patches.shape[2:])
    out = fn(flat) if mesh is None else _sharded(fn, flat, mesh, mesh_axis)
    sizes = [v * out_scale for v in (ks, h, w, *sy, *sx)]
    if not all(float(v).is_integer() for v in sizes):
        raise ValueError(f"tiled_apply: ks {ks}, stride {stride}, canvas {h}x{w} do not scale "
                         f"by {out_scale} to whole pixels")
    oks, oh, ow = (int(v) for v in sizes[:3])
    osy = [int(v) for v in sizes[3:3 + len(sy)]]
    osx = [int(v) for v in sizes[3 + len(sy):]]
    return fold_patches(out.reshape((b, p) + out.shape[1:]), (oh, ow), oks, osy, osx,
                        clip_min, clip_max)
