"""K8 and X3: Winograd F(2x2, 3x3) stride-1 SAME convolution, bias-free.

K8 replaces the TPU kernel ``_kernel`` of
``sd_tpu/ops/pallas/winograd_conv.py`` (through ``_wino_pallas``, entry
``winograd_conv3x3``), which reads the four parity planes of the padded
input that the host prepares (:func:`_parity_planes`). X3 replaces the
experiment kernel inside ``wino_split`` of ``tools/exp_winograd.py``
(``timing_split``): the same conv, with the padded input read whole and
split into parities inside the kernel; the port's X3 reads the unpadded
input and makes the border zeros by bounds checks, so no host pass is made.
Both are one CUDA source, ``sd_tpu_torch/csrc/winograd_conv.cu``; its header
says what bounds them on the H100.

Per 4x4 input tile d (stride 2) and 2x2 output tile, correlation convention
(Lavin & Gray)::

    Y = Aᵀ [ U ⊙ (Bᵀ d B) ] A,   U = G w Gᵀ   (:func:`weight_transform`, fp32)

The input transform is computed in fp32 and rounded once to the
activation dtype; the 16 products run with fp32 accumulation; the output
transform combines over b first, then over a, in fp32, as ``_kernel`` does.

``winograd_conv3x3`` and ``winograd_conv3x3_split`` take NCHW ``x`` and an
OIHW ``w``. They launch their kernel for a CUDA tensor and compute
:func:`winograd_conv3x3_plain` for a CPU tensor only; a CUDA tensor that is
not bf16, or an odd H or W, raises. Each counts its launches in
``.launches``. Where autograd records, the backward recomputes through the
direct conv, as ``sd_tpu``'s ``_wino_bwd`` does.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import torch
import torch.nn.functional as F

from sd_tpu_torch.ops.cuda._build import check, kernels, stream_of

__all__ = ["winograd_conv3x3", "winograd_conv3x3_split", "winograd_conv3x3_plain",
           "winograd_supported", "weight_transform", "parse_conv_impl"]

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


def winograd_conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch with the kernel's roundings: the
    input transform in fp32, rounded once to the dtype of ``x``; U rounded to
    it; the products and the output transform in fp32; one rounding."""
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(f"winograd_conv3x3: H and W must be even, got {tuple(x.shape)}")
    b, c, h, wd = x.shape
    k = w.shape[0]
    r, s = h // 2, wd // 2
    with torch.autocast(x.device.type, enabled=False):
        u = weight_transform(w).to(x.dtype).float()
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


def _launch(x: torch.Tensor, w: torch.Tensor, split: bool) -> torch.Tensor:
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
    u = weight_transform(w).to(x.dtype).contiguous()
    x = x.contiguous()
    y = torch.empty((b, k, h, wd), dtype=x.dtype, device=x.device)
    planes = [None] * 4 if split else [p.contiguous() for p in _parity_planes(x)]
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = kernels()
    with torch.cuda.device(x.device):
        err = lib.sdt_winograd_conv3x3(*map(ptr, planes), ptr(x) if split else None,
                                       u.data_ptr(), y.data_ptr(), b, c, h, wd, k, int(split),
                                       stream_of(x))
    check(err, what)
    return y


def _forward(x: torch.Tensor, w: torch.Tensor, split: bool) -> torch.Tensor:
    if x.device.type == "cpu":
        return winograd_conv3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"winograd_conv3x3: no path for device {x.device}")
    y = _launch(x, w, split)
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


def _conv(x: torch.Tensor, w: torch.Tensor, split: bool) -> torch.Tensor:
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if torch.is_autocast_enabled(x.device.type):
            dtype = torch.get_autocast_dtype(x.device.type)
            x, w = x.to(dtype), w.to(dtype)
        with torch.autocast(x.device.type, enabled=False):
            return _Winograd.apply(x, w, split)
    return _forward(x, w, split)


def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K8: F(2x2,3x3) SAME stride-1 conv of NCHW ``x`` with OIHW ``w``,
    bias-free; the kernel reads the four parity planes built here."""
    return _conv(x, w, split=False)


def winograd_conv3x3_split(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X3: the same conv, with the parity split and the border zeros made
    inside the kernel from the unpadded ``x``."""
    return _conv(x, w, split=True)


winograd_conv3x3.launches = 0
winograd_conv3x3_split.launches = 0
