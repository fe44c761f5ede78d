"""K7: fused GroupNorm-apply + SiLU + 3x3 conv (+bias, +skip, moments).

Replaces the TPU kernel ``_kernel`` of ``sd_tpu/ops/pallas/fused_conv.py``
(through ``_fused_pallas``, entry ``fused_conv3x3``). The CUDA source is
``sd_tpu_torch/csrc/fused_conv.cu``, an implicit GEMM on ``wgmma``; its
header says what bounds it on the H100 and how it is laid out. It reads the
weight repacked as ``wk [9, N, C]`` (:func:`repack_weight`: ``sd_tpu``'s
``w9 [9, C, N]`` with its last two axes swapped), which
:func:`repacked_weight` caches per weight version for the resnet blocks.

The function, in the port's NCHW / OIHW layout::

    h = bf16(silu(x * a[b, c] + d[b, c]))      (or h = x without a and d)
    y = bf16(conv3x3_same(h, w) + bias + skip)  (fp32 accumulation, one rounding)
    moments: sum and sum of squares of y (as rounded) over H, W, per (b, n)

The SAME zero padding lies in the normalized domain: the border taps read
0, not ``silu(d)``. ``a`` and ``d`` are the folded GroupNorm affine of
:func:`fold_gn_affine`.

``fused_conv3x3`` launches the kernel for a CUDA tensor and computes
:func:`fused_conv3x3_plain` for a CPU tensor only; a CUDA tensor that is
not bf16, or a shape the kernel does not take, raises.
``fused_conv3x3.launches`` counts calls that launch it (one a call, where
a split over C adds a second kernel). Where autograd records, a
``torch.autograd.Function`` runs the same forward and, backward, recomputes
through the plain version, as ``sd_tpu``'s ``_fc_bwd`` recomputes through
``_reference``.

:func:`fused_conv_supported` is ``sd_tpu``'s shape gate, with its TPU tile
picker and VMEM estimate kept as a gate only (the CUDA kernel picks its own
tiles), so that both packages take exactly the same sites.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.ops.cuda._build import check, kernels, stream_of

__all__ = ["fused_conv3x3", "fused_conv3x3_plain", "fused_conv_supported",
           "fused_conv_enabled", "parse_fused_conv", "fold_gn_affine", "repack_weight",
           "repacked_weight", "kernel_plan"]

_LOG2E = 1.4426950408889634
# sd_tpu's VMEM budget: part of the gate's definition, not a limit of the card
_VMEM_BUDGET = 13 * 1024 * 1024
# the CUDA kernel's block: 8 x 16 output pixels, 64 input channels a step
# (csrc/fused_conv.cu)
_TILE_ROWS, _TILE_COLS = 8, 16
_BLOCK_CHANNELS = 64
_FUSED_MODES = {"": "auto", "auto": "auto", "0": "off", "off": "off", "1": "force",
                "force": "force"}


def parse_fused_conv(spec: Optional[str] = None) -> str:
    """``SD_TPU_FUSED_CONV``'s value (None reads the variable, unset is
    ``auto``) as ``"auto"``, ``"off"`` or ``"force"``; an unknown value raises."""
    if spec is None:
        spec = os.environ.get("SD_TPU_FUSED_CONV", "auto")
    key = str(spec).strip().lower()
    if key not in _FUSED_MODES:
        raise ValueError(f"SD_TPU_FUSED_CONV: {spec!r} is not one of auto, 0, off, 1, force")
    return _FUSED_MODES[key]


def fused_conv_enabled(mode: str) -> bool:
    """The dispatch decision of ``sd_tpu``'s ``fused_conv_enabled`` for a
    mode held on a module: on only where it was asked for (``1``/``force``);
    ``auto`` keeps it off, as ``sd_tpu`` does off interpret mode."""
    return parse_fused_conv(mode) == "force"


def _silu_f32(xf: torch.Tensor) -> torch.Tensor:
    return xf * (1.0 / (1.0 + torch.exp2(xf * -_LOG2E)))


def _pad128(v: int) -> int:
    return -(-v // 128) * 128


def _vmem_estimate(trh: int, w_img: int, c: int, tk: int, itemsize: int) -> int:
    cp, tkp = _pad128(c), _pad128(tk)
    win = (trh + 2) * w_img * cp * itemsize
    win_f32 = (trh + 2) * w_img * cp * 4
    return (9 * c * tkp * itemsize + 2 * win + 3 * win + win_f32
            + trh * w_img * tkp * 4 + 4 * trh * w_img * tkp * itemsize)


def _pick_tiles(h_img: int, w_img: int, c: int, n: int, itemsize: int):
    if h_img % 8 or w_img % 16 or w_img < 16 or c % 128:
        return None, None
    trh = 8
    candidates = [n] + [t for t in (1280, 1024, 768, 640, 512, 384, 256, 128)
                        if t < n and n % t == 0 and t % 128 == 0]
    for tk in candidates:
        if tk != n and tk % 128:
            continue
        if _vmem_estimate(trh, w_img, c, tk, itemsize) <= _VMEM_BUDGET:
            return trh, tk
    return None, None


def fused_conv_supported(x_shape: Sequence[int], w_shape: Sequence[int],
                         dtype: torch.dtype) -> bool:
    """``sd_tpu``'s gate on an NCHW ``x_shape`` and an OIHW ``w_shape``."""
    if len(x_shape) != 4 or tuple(w_shape[2:]) != (3, 3):
        return False
    _, c, h_img, w_img = x_shape
    n = w_shape[0]
    if dtype not in (torch.bfloat16, torch.float32):
        return False
    if h_img % 8 or w_img % 16 or w_img < 16 or c < 128 or n < 128:
        return False
    itemsize = torch.empty((), dtype=dtype).element_size()
    return _pick_tiles(h_img, w_img, c, n, itemsize)[0] is not None


def fold_gn_affine(mean: torch.Tensor, meansq: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, eps: float, extra_scale=None, channel_offset=None,
                   extra_shift=None):
    """Fold per-(B, G) fp32 statistics of the prologue input t = x +
    ``channel_offset``, the GroupNorm's scale and bias, and an optional FiLM
    ``extra_scale``/``extra_shift`` into ``A, D [B, C]`` fp32 with
    ``x * A + D == ((t - mean) * rstd * scale + bias) * extra_scale + extra_shift``.
    The variance is clamped at 0 as in ``GroupNorm32``."""
    g = mean.shape[-1]
    c = scale.shape[-1]
    cg = c // g
    rstd = torch.rsqrt(torch.clamp_min(meansq - mean.square(), 0.0) + eps)
    rstd_c = rstd.repeat_interleave(cg, dim=-1)
    mean_c = mean.repeat_interleave(cg, dim=-1)
    a = rstd_c * scale[None, :]
    off = -mean_c
    if channel_offset is not None:
        off = off + channel_offset
    dd = off * rstd_c * scale[None, :] + bias[None, :]
    if extra_scale is not None:
        a = a * extra_scale
        dd = dd * extra_scale
    if extra_shift is not None:
        dd = dd + extra_shift
    return a.float(), dd.float()


def repack_weight(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``w [N, C, 3, 3]`` as the kernel reads it: ``wk [9, N, C]``, tap
    ``3 dy + dx`` major, each output channel's C contiguous (``sd_tpu``'s
    ``w9 = hwio.reshape(9, C, N)`` with its last two axes swapped)."""
    n, c = w.shape[:2]
    return w.permute(2, 3, 0, 1).reshape(9, n, c).contiguous()


def repacked_weight(conv: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """:func:`repack_weight` of ``conv.weight`` in ``dtype``, computed once
    per weight version and kept on the module (any ``nn.Conv2d``), keyed as
    ``Conv3x3.winograd_u`` keys U: a replaced or in-place edited weight is
    repacked again. For calls where autograd does not record."""
    w = conv.weight
    key = (w.data_ptr(), w.dtype, w.device, w._version, dtype)
    cache = getattr(conv, "_fused_conv_cache", None)
    if cache is None or cache[0] != key:
        with torch.no_grad():
            cache = (key, repack_weight(w.to(dtype)))
        conv._fused_conv_cache = cache
    return cache[1]


def fused_conv3x3_plain(x: torch.Tensor, w: torch.Tensor, a=None, d=None, bias=None,
                        skip=None, emit_moments: bool = False):
    """The same function in plain PyTorch (``sd_tpu``'s ``_reference``):
    the prologue in fp32 rounded to the dtype of ``x``, the conv in fp32 on
    those values, bias and skip in fp32, one rounding; the moments square
    the rounded output in fp32."""
    with torch.autocast(x.device.type, enabled=False):
        if a is not None:
            xf = x.float() * a[:, :, None, None] + d[:, :, None, None]
            h = _silu_f32(xf).to(x.dtype)
        else:
            h = x
        y = F.conv2d(h.float(), w.to(x.dtype).float(), padding=1)
        if bias is not None:
            y = y + bias.float()[:, None, None]
        if skip is not None:
            y = y + skip.float()
        yb = y.to(x.dtype)
        if emit_moments:
            yf = yb.float()
            return yb, yf.sum(dim=(2, 3)), yf.square().sum(dim=(2, 3))
        return yb


def _check_inputs(x, w, a, d, bias, skip, wk=None):
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"fused_conv3x3: x {x.dtype}, w {w.dtype}; the card's path is bfloat16")
    if x.ndim != 4:
        raise ValueError(f"fused_conv3x3: x must be NCHW, got {tuple(x.shape)}")
    b, c, h_img, w_img = x.shape
    n = w.shape[0]
    if tuple(w.shape) != (n, c, 3, 3):
        raise ValueError(f"fused_conv3x3: w {tuple(w.shape)} is not [N, {c}, 3, 3]")
    if w.device != x.device:
        raise ValueError(f"fused_conv3x3: w is on {w.device}, x on {x.device}")
    if (w_img % _TILE_COLS or h_img % _TILE_ROWS or c % _BLOCK_CHANNELS or n % 8
            or x.numel() == 0):
        raise ValueError(f"fused_conv3x3: unsupported shape x {tuple(x.shape)}, N={n} (W % 16, "
                         f"H % 8, C % {_BLOCK_CHANNELS}, N % 8) — gate with "
                         f"fused_conv_supported")
    if wk is not None and (tuple(wk.shape) != (9, n, c) or wk.dtype != torch.bfloat16
                           or wk.device != x.device):
        raise ValueError(f"fused_conv3x3: wk {wk.dtype} {tuple(wk.shape)} on {wk.device} is not "
                         f"bf16 [9, {n}, {c}] on {x.device}")
    for name, t, shape in (("a", a, (b, c)), ("d", d, (b, c)), ("bias", bias, (n,)),
                           ("skip", skip, (b, n, h_img, w_img))):
        if t is None:
            continue
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_conv3x3: {name} {tuple(t.shape)}, expected {shape}")
        if t.device != x.device:
            raise ValueError(f"fused_conv3x3: {name} is on {t.device}, x on {x.device}")
    if skip is not None and skip.dtype != torch.bfloat16:
        raise TypeError(f"fused_conv3x3: skip is {skip.dtype}; the card's path is bfloat16")


@functools.lru_cache(maxsize=256)
def _plan(b: int, c: int, h: int, w: int, n: int, device: int) -> tuple:
    out = (ctypes.c_int * 8)()
    with torch.cuda.device(device):
        err = kernels().sdt_fused_conv_plan(b, c, h, w, n, out)
    check(err, f"fused_conv3x3 plan at {(b, c, h, w, n)}")
    return tuple(out)


def kernel_plan(b: int, c: int, h: int, w: int, n: int) -> dict:
    """K7's plan at ``x [b, c, h, w]`` and N = ``n``, from the loaded
    library: a block's output rows, columns and channels, the stages of its
    weight ring, the splits over C, the 64-channel steps a split takes, the
    blocks launched and a block's shared memory. Needs the card."""
    keys = ("rows", "cols", "channels", "stages", "splits", "steps_per_split", "blocks",
            "smem_bytes")
    return dict(zip(keys, _plan(b, c, h, w, n, torch.cuda.current_device())))


def _launch(x, w, a, d, bias, skip, emit_moments, wk):
    _check_inputs(x, w, a, d, bias, skip, wk)
    b, c, h_img, w_img = x.shape
    n = w.shape[0]
    tiles = (h_img // _TILE_ROWS) * (w_img // _TILE_COLS)
    x = x.contiguous()
    wk = repack_weight(w) if wk is None else wk.contiguous()
    f32 = lambda t: None if t is None else t.to(torch.float32).contiguous()
    a, d, bias = f32(a), f32(d), f32(bias)
    skip = None if skip is None else skip.contiguous()
    plan = _plan(b, c, h_img, w_img, n, x.device.index if x.device.index is not None
                 else torch.cuda.current_device())
    y = torch.empty((b, n, h_img, w_img), dtype=x.dtype, device=x.device)
    ws = m1 = m2 = None
    if plan[4] > 1:
        ws = torch.empty((plan[4], b, n, h_img, w_img), dtype=torch.float32, device=x.device)
    if emit_moments:
        moments = torch.empty((2, b, tiles, n), dtype=torch.float32, device=x.device)
        m1, m2 = moments
    for name, t in (("x", x), ("wk", wk), ("skip", skip)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"fused_conv3x3: {name} is not 16-byte aligned")
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = kernels()
    with torch.cuda.device(x.device):
        err = lib.sdt_fused_conv3x3(ptr(x), ptr(wk), ptr(a), ptr(d), ptr(bias), ptr(skip),
                                    ptr(y), ptr(m1), ptr(m2), ptr(ws), b, c, h_img, w_img, n,
                                    stream_of(x))
    check(err, "fused_conv3x3")
    fused_conv3x3.launches += 1
    if emit_moments:
        # per-tile partial sums, added in a fixed order (no float atomics)
        s1, s2 = moments.sum(dim=2)
        return y, s1, s2
    return y


def _forward(x, w, a, d, bias, skip, emit_moments, wk=None):
    if x.device.type == "cpu":
        return fused_conv3x3_plain(x, w, a, d, bias, skip, emit_moments)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv3x3: no path for device {x.device}")
    return _launch(x, w, a, d, bias, skip, emit_moments, wk)


class _FusedConv(torch.autograd.Function):
    """K7 forward; backward by recomputing the plain version (no kernel)."""

    @staticmethod
    def forward(ctx, x, w, a, d, bias, skip, emit_moments):
        ctx.emit_moments = emit_moments
        ctx.save_for_backward(x, w, a, d, bias, skip)
        return _forward(x, w, a, d, bias, skip, emit_moments)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            out = fused_conv3x3_plain(*inputs, emit_moments=ctx.emit_moments)
            outs = out if ctx.emit_moments else (out,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                           [g for _, g in pairs], allow_unused=True))
        return tuple(next(got) if t is not None and t.requires_grad else None
                     for t in inputs) + (None,)


def fused_conv3x3(x: torch.Tensor, w: torch.Tensor, *, a: Optional[torch.Tensor] = None,
                  d: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                  skip: Optional[torch.Tensor] = None, emit_moments: bool = False,
                  wk: Optional[torch.Tensor] = None):
    """(affine + SiLU) -> conv3x3 -> (+bias, +skip, moments) on NCHW ``x``
    ``[B, C, H, W]`` and an OIHW ``w [N, C, 3, 3]``; ``a``/``d`` ``[B, C]``
    fp32 (both or neither), ``bias [N]``, ``skip [B, N, H, W]``; ``wk`` the
    kernel's :func:`repack_weight` of ``w`` where the caller keeps it (read
    only where autograd does not record; else the call repacks ``w``).
    Returns ``y`` or ``(y, sum [B, N], sumsq [B, N])`` of the rounded ``y``."""
    if (a is None) != (d is None):
        raise ValueError("fused_conv3x3: a and d must be given together")
    args = (x, w, a, d, bias, skip)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        if torch.is_autocast_enabled(x.device.type):
            dtype = torch.get_autocast_dtype(x.device.type)
            x, w = x.to(dtype), w.to(dtype)
            skip = None if skip is None else skip.to(dtype)
        with torch.autocast(x.device.type, enabled=False):
            return _FusedConv.apply(x, w, a, d, bias, skip, emit_moments)
    return _forward(*args, emit_moments, wk)


fused_conv3x3.launches = 0
