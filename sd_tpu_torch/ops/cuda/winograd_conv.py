"""K8 and X3: Winograd F(2x2, 3x3) stride-1 SAME convolution, bias-free.

K8 replaces the TPU kernel ``_kernel`` of
``sd_tpu/ops/pallas/winograd_conv.py`` (through ``_wino_pallas``, entry
``winograd_conv3x3``), which reads the four parity planes of the padded
input that the host prepares (:func:`_parity_buffer`, all four in one copy
with 16-byte rows). X3 replaces the
experiment kernel inside ``wino_split`` of ``tools/exp_winograd.py``
(``timing_split``): the same conv, with the padded input read whole and
split into parities inside the kernel; the port's X3 reads the unpadded
input and makes the border zeros with the copies' zero fill, so no host
pass is made. Both are one CUDA source, ``sd_tpu_torch/csrc/winograd_conv.cu``;
its header says what bounds them on the H100.

Per 4x4 input tile d (stride 2) and 2x2 output tile, correlation convention
(Lavin & Gray)::

    Y = Aᵀ [ U ⊙ (Bᵀ d B) ] A,   U = G w Gᵀ   (:func:`weight_transform`, fp32)

The input transform is computed in fp32 and rounded once to the
activation dtype; the 16 products run with fp32 accumulation; the output
transform combines over b first, then over a, in fp32, as ``_kernel`` does.

``winograd_conv3x3`` and ``winograd_conv3x3_split`` take NCHW ``x``, an
OIHW ``w`` and, optionally, ``u``: U already transformed and rounded to the
dtype of ``x`` (``Conv3x3`` keeps it beside its weight, computed once per
weight version). Without ``u``, or where autograd records, U is computed
per call. They launch their kernel for a CUDA tensor and compute
:func:`winograd_conv3x3_plain` for a CPU tensor only; a CUDA tensor that is
not bf16, or an odd H or W, raises. Each counts its launches in
``.launches``. Where autograd records, the backward recomputes through the
direct conv, as ``sd_tpu``'s ``_wino_bwd`` does. :func:`kernel_plan` reads
the launch plan the library chooses at a shape.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from sd_tpu_torch.ops.cuda._build import check, kernels, stream_of

__all__ = ["winograd_conv3x3", "winograd_conv3x3_split", "winograd_conv3x3_plain",
           "winograd_supported", "weight_transform", "parse_conv_impl", "kernel_plan"]

_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))
_BT = ((1.0, 0.0, -1.0, 0.0), (0.0, 1.0, 1.0, 0.0), (0.0, -1.0, 1.0, 0.0),
       (0.0, 1.0, 0.0, -1.0))
_AT = ((1.0, 1.0, 1.0, 0.0), (0.0, 1.0, -1.0, -1.0))
_CONV_IMPLS = {"": "auto", "auto": "auto", "xla": "auto", "winograd": "winograd"}


def parse_conv_impl(spec=None) -> str:
    """``SD_TPU_CONV_IMPL``'s value (None reads the variable) as ``"auto"``
    (the direct conv, or the int8 conv where its bucket is on) or
    ``"winograd"`` (K8 where :func:`winograd_supported` passes); an unknown
    value raises."""
    if spec is None:
        spec = os.environ.get("SD_TPU_CONV_IMPL", "auto")
    key = str(spec).strip().lower()
    if key not in _CONV_IMPLS:
        raise ValueError(f"SD_TPU_CONV_IMPL: {spec!r} is not one of auto, xla, winograd")
    return _CONV_IMPLS[key]


def weight_transform(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``w [K, C, 3, 3]`` -> ``U [16, C, K]`` fp32: G w Gᵀ per channel pair."""
    g = torch.tensor(_G, dtype=torch.float32, device=w.device)
    u = torch.einsum("ai,bj,kcij->abck", g, g, w.float())
    return u.reshape(16, w.shape[1], w.shape[0])


def _parity_planes(x: torch.Tensor) -> List[torch.Tensor]:
    """Pad SAME and split NCHW ``x`` into the four parity planes
    ``[B, C, H/2+1, W/2+1]``, in the order P00 P01 P10 P11."""
    r, s = x.shape[2] // 2, x.shape[3] // 2
    xp = F.pad(x, (1, 1, 1, 1))
    return [xp[:, :, i:i + 2 * r + 1:2, j:j + 2 * s + 1:2] for i in (0, 1) for j in (0, 1)]


def _parity_buffer(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """K8's input: the four parity planes of the SAME-padded NCHW ``x`` in
    one buffer ``[B, C, 2, 2, H/2+1, S1p]`` (``[:, :, i, j]`` is ``P_ij``),
    built by one pad and one copy, and its row pitch ``S1p``: ``W/2 + 1``
    rounded up to a multiple of 8 elements (16-byte rows), the extra columns
    zero."""
    b, c, h, w = x.shape
    r, s = h // 2, w // 2
    s1p = -(-(s + 1) // 8) * 8
    xp = F.pad(x, (1, 2 * s1p - w - 1, 1, 1))
    planes = xp.view(b, c, r + 1, 2, s1p, 2).permute(0, 1, 3, 5, 2, 4).contiguous()
    return planes, s1p


def winograd_supported(x_shape: Sequence[int], w_shape: Sequence[int], dtype: torch.dtype,
                       device) -> bool:
    """``sd_tpu``'s ``winograd_supported`` on an NCHW ``x_shape`` and an OIHW
    ``w_shape``, with a CUDA device in place of the TPU backend (the mode
    itself is held on ``Conv3x3.impl``, not read here). Whether the kernel
    CAN run at this shape, not whether it should."""
    if torch.device(device).type != "cuda" or dtype != torch.bfloat16:
        return False
    if len(x_shape) != 4 or tuple(w_shape[2:]) != (3, 3):
        return False
    _, c, h, w = x_shape
    k = w_shape[0]
    if h % 2 or w % 2 or h < 16 or w < 16:
        return False
    if h // 2 > 16 and (h // 2) % 8:
        return False
    return (w // 2) % 16 == 0 and 128 <= c <= 1280 and k >= 128


def winograd_conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                           u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function in plain PyTorch with the kernel's roundings: the
    input transform in fp32, rounded once to the dtype of ``x``; U (``u``, or
    :func:`weight_transform` of ``w``) rounded to it; the products and the
    output transform in fp32; one rounding."""
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"winograd_conv3x3: H and W must be even, got {tuple(x.shape)}")
    b, c, h, wd = x.shape
    k = w.shape[0]
    r, s = h // 2, wd // 2
    with torch.autocast(x.device.type, enabled=False):
        u = (weight_transform(w) if u is None else u).to(x.dtype).float()
        planes = [p.float() for p in _parity_planes(x)]
        d = [[planes[2 * (i % 2) + j % 2][:, :, i // 2:i // 2 + r, j // 2:j // 2 + s]
              for j in range(4)] for i in range(4)]
        bt = torch.tensor(_BT)
        t = [[sum(bt[a, i] * d[i][j] for i in range(4) if bt[a, i]) for j in range(4)]
             for a in range(4)]
        v = torch.stack([sum(bt[bb, j] * t[a][j] for j in range(4) if bt[bb, j])
                         for a in range(4) for bb in range(4)])
        v = v.to(x.dtype).float().reshape(16, b, c, r * s)
        m = torch.einsum("zbct,zck->zbkt", v, u).reshape(4, 4, b, k, r, s)
        y = torch.empty((b, k, h, wd), dtype=torch.float32, device=x.device)
        for p in range(2):
            for q in range(2):
                acc = 0.0
                for a in range(4):
                    if _AT[p][a]:
                        z = sum(_AT[q][bb] * m[a, bb] for bb in range(4) if _AT[q][bb])
                        acc = acc + _AT[p][a] * z
                y[:, :, p::2, q::2] = acc
        return y.to(x.dtype)


def _launch(x: torch.Tensor, w: torch.Tensor, split: bool,
            u: Optional[torch.Tensor]) -> torch.Tensor:
    what = "winograd_conv3x3_split" if split else "winograd_conv3x3"
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: x is {x.dtype}; the card's path is bfloat16")
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"{what}: x {tuple(x.shape)} and w {tuple(w.shape)} do not match")
    if w.device != x.device:
        raise ValueError(f"{what}: w is on {w.device}, x on {x.device}")
    b, c, h, wd = x.shape
    k = w.shape[0]
    if h % 2 or wd % 2:
        raise ValueError(f"{what} needs even H and W, got {h}x{wd}: the parity planes "
                         f"would drop rows")
    if k % 8 or x.numel() == 0:
        raise ValueError(f"{what}: K={k} must be a multiple of 8 and x non-empty")
    if u is None:
        u = weight_transform(w).to(x.dtype)
    if (tuple(u.shape) != (16, c, k) or u.dtype != x.dtype or u.device != x.device
            or not u.is_contiguous()):
        raise ValueError(f"{what}: u {tuple(u.shape)} {u.dtype} on {u.device} is not U "
                         f"[16, {c}, {k}] {x.dtype}, contiguous, on {x.device}")
    if split:
        src, s1p = x.contiguous(), 0
    else:
        src, s1p = _parity_buffer(x)
    align = 16 if not split or wd % 8 == 0 else 4
    if src.data_ptr() % align or u.data_ptr() % 16:
        raise ValueError(f"{what}: the input must be {align}-byte and u 16-byte aligned")
    y = torch.empty((b, k, h, wd), dtype=x.dtype, device=x.device)
    lib = kernels()
    with torch.cuda.device(x.device):
        err = lib.sdt_winograd_conv3x3(src.data_ptr(), u.data_ptr(), y.data_ptr(), b, c, h, wd,
                                       k, s1p, int(split), stream_of(x))
    check(err, what)
    return y


def kernel_plan(x_shape: Sequence[int], k: int, split: bool = False) -> dict:
    """The launch plan the library chooses for K8 (or X3, ``split``) on NCHW
    ``x_shape`` with ``k`` output channels: the plan's index, the patch of
    tiles a block owns (rows x columns of 2x2 tiles), output channels a
    block, input channels a step, threads and shared-memory bytes per block,
    resident blocks per SM and the grid's blocks. Needs the card."""
    b, _, h, w = x_shape
    out = (ctypes.c_int * 9)()
    check(kernels().sdt_winograd_plan(int(split), b, h, w, k, out),
          f"winograd plan at {tuple(x_shape)} -> {k}")
    return dict(zip(("plan", "tile_rows", "tile_cols", "channels", "channel_step", "threads",
                     "smem_bytes", "blocks_per_sm", "blocks"), out))


def _forward(x: torch.Tensor, w: torch.Tensor, split: bool,
             u: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x.device.type == "cpu":
        return winograd_conv3x3_plain(x, w, u)
    if x.device.type != "cuda":
        raise ValueError(f"winograd_conv3x3: no path for device {x.device}")
    y = _launch(x, w, split, u)
    if split:
        winograd_conv3x3_split.launches += 1
    else:
        winograd_conv3x3.launches += 1
    return y


class _Winograd(torch.autograd.Function):
    """K8 or X3 forward; backward through the direct conv (no kernel)."""

    @staticmethod
    def forward(ctx, x, w, split):
        ctx.save_for_backward(x, w)
        return _forward(x, w, split)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip((x, w), ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = F.conv2d(inputs[0], inputs[1].to(x.dtype), padding=1)
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,)


def _conv(x: torch.Tensor, w: torch.Tensor, split: bool,
          u: Optional[torch.Tensor]) -> torch.Tensor:
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if torch.is_autocast_enabled(x.device.type):
            dtype = torch.get_autocast_dtype(x.device.type)
            x, w = x.to(dtype), w.to(dtype)
        with torch.autocast(x.device.type, enabled=False):
            return _Winograd.apply(x, w, split)
    return _forward(x, w, split, u)


def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K8: F(2x2,3x3) SAME stride-1 conv of NCHW ``x`` with OIHW ``w``,
    bias-free; the kernel reads the parity buffer built here
    (:func:`_parity_buffer`). ``u``: U [16, C, K] in the dtype of ``x``,
    used where autograd does not record."""
    return _conv(x, w, False, u)


def winograd_conv3x3_split(x: torch.Tensor, w: torch.Tensor,
                           u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """X3: the same conv, with the parity split and the border zeros made
    inside the kernel from the unpadded ``x``."""
    return _conv(x, w, True, u)


winograd_conv3x3.launches = 0
winograd_conv3x3_split.launches = 0
