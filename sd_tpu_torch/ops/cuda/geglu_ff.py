"""K2: the fused GEGLU feed-forward, ``y = (a · gelu(g)) W2ᵀ + b2``.

Replaces the TPU kernel ``_kernel`` of ``sd_tpu/ops/pallas/geglu_ff.py``
(through ``_geglu_ff``, entry ``geglu_ff``). The CUDA kernels are in
``sd_tpu_torch/csrc/geglu_ff.cu``; its header says what bounds them on the
H100, why the TPU kernel's single pass became two launches there (three
where the second GEMM splits over k) and how both GEMMs run on ``wgmma``.
:func:`kernel_plan` reads the plan the library takes at a shape.

Weights are in torch ``Linear`` layout: ``w1`` is ``[2·inner, C]`` with the
value rows first and the gate rows second (the reference's
``chunk(2, dim=-1)`` order), ``w2`` is ``[C_out, inner]``.

``geglu_ff`` launches the kernels for a CUDA tensor and uses
:func:`geglu_ff_plain` for a CPU tensor only. A CUDA tensor that is not
bf16, or a shape the kernels do not take, raises. ``geglu_ff.launches``
counts calls that launched (one per call, whatever the internal launches).

:func:`differentiable_geglu_ff` is the entry point for code that may need
gradients: where autograd records, a ``torch.autograd.Function`` runs K2
forward and, backward, recomputes through :func:`geglu_ff_plain` and takes
its vector-Jacobian product, as ``sd_tpu``'s ``_geglu_ff_bwd`` does through
``_split_reference`` (the JAX package has no backward kernel here).

K4, the W8A8 variant of the int8 serving mode's ``ff`` bucket, replaces
``_kernel_int8`` through ``_geglu_ff_int8``; its source is
``sd_tpu_torch/csrc/geglu_ff_int8.cu`` (its first GEMM is K6's kernel of
``int8_wgmma.cuh`` with a GEGLU epilogue), whose header says what bounds it
and how h, kept in fp32, is quantized as the output GEMM loads it.
``geglu_ff_int8`` quantizes x and h per row and reads weights quantized per
output channel (``quantize_cols``, at load time or inline with the same
math), with W1's value and gate rows interleaved in runs of 64
(:func:`interleave_runs`, built once by :func:`quantize_ff_weights`);
``geglu_ff_int8.launches`` counts its calls that launched (one a call: two
kernels and a memset). :func:`int8_kernel_plan` reads its plans. The GELU
there is always ``sd_tpu``'s short erf polynomial (:func:`gelu_fast`).
:func:`int8_ff_supported` is the site gate: the ``ff`` bucket, inner >=
``_INT8_MIN_INNER``, a width K4 takes (C a multiple of 32 up to 1280) and
the fused FF's row rule (M >= 1024, M % 256 == 0); other sites keep K2.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from sd_tpu_torch.ops import quant
from sd_tpu_torch.ops.cuda._build import check, kernels, stream_of
from sd_tpu_torch.ops.cuda.int8_dense import int8_width_ok
from sd_tpu_torch.ops.quant import check_no_grad, int8_matmul_exact, quantize_rows

__all__ = ["geglu_ff", "geglu_ff_plain", "differentiable_geglu_ff", "geglu_ff_int8",
           "geglu_ff_int8_plain", "quantize_cols", "quantize_ff_weights", "interleave_runs",
           "gelu_fast", "int8_ff_supported", "kernel_plan", "int8_kernel_plan"]

# sd_tpu's _ERF_FAST: erf(x) ~ x * P6(x^2) on |x| <= 3, coefficients low to high
_ERF_FAST = (
    1.12646408, -0.366942461, 0.0998401577, -0.0183764236, 0.00211666563,
    -0.000135903813, 3.68124527e-06,
)
_SQRT_HALF = 0.7071067811865476
# the int8 FF only where sd_tpu measured it faster: inner 2560 and 5120
_INT8_MIN_INNER = 2560
# K4's first GEMM keeps a block's rows of x quantized whole (int8_wgmma.cuh)
_MAX_INT8_C = 1280
# the rows of W1a and W1g alternate in runs of this many in K4's weight
_INT8_RUN = 64


def geglu_ff_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function in plain PyTorch: fp32 products, exact-erf GELU in
    fp32, h rounded to the input dtype before the output projection. With
    ``residual`` (K2's residual mode, which X2 runs), the rounded output
    plus ``residual``, rounded: ``bf16(bf16(h W2ᵀ + b2) + residual)``."""
    inner = w2.shape[1]
    with torch.autocast(x.device.type, enabled=False):
        s = F.linear(x.float(), w1.float(), b1.float())
        a, g = s[..., :inner], s[..., inner:]
        h = (a * F.gelu(g)).to(x.dtype)
        y = F.linear(h.float(), w2.float(), b2.float()).to(x.dtype)
        return y if residual is None else y + residual


def _check_inputs(x, w1, b1, w2, b2):
    for name, t in (("x", x), ("w1", w1), ("w2", w2)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"geglu_ff: {name} is {t.dtype}; the card's path is "
                            f"bfloat16")
    for name, t in (("w1", w1), ("b1", b1), ("w2", w2), ("b2", b2)):
        if t.device != x.device:
            raise ValueError(f"geglu_ff: {name} is on {t.device}, x on {x.device}")
    c = x.shape[-1]
    c_out, inner = w2.shape
    if w1.shape != (2 * inner, c) or b1.shape != (2 * inner,) or b2.shape != (c_out,):
        raise ValueError(
            f"geglu_ff: shapes x {tuple(x.shape)}, w1 {tuple(w1.shape)}, b1 "
            f"{tuple(b1.shape)}, w2 {tuple(w2.shape)}, b2 {tuple(b2.shape)} "
            f"do not match")
    if c % 8 or inner % 8 or c_out % 8:
        raise ValueError(f"geglu_ff: C={c}, inner={inner} and C_out={c_out} must be "
                         f"multiples of 8")
    if x.numel() == 0:
        raise ValueError("geglu_ff: empty input")


@functools.lru_cache(maxsize=256)
def _workspace(device: int, m: int, c: int, inner: int, c_out: int) -> int:
    """The fp32 elements of the second GEMM's k-split scratch at this shape
    (0: it does not split), from the library's plan on ``device``."""
    out = ctypes.c_longlong()
    lib = kernels()
    with torch.cuda.device(device):
        err = lib.sdt_geglu_ff_workspace(m, c, inner, c_out, ctypes.byref(out))
    check(err, f"geglu_ff workspace at {(m, c, inner, c_out)}")
    return out.value


def kernel_plan(m: int, c: int, inner: int, c_out: Optional[int] = None) -> dict:
    """K2's plan at ``x [m, c]``, inner ``inner`` (``c_out`` defaults to
    ``c``), from the loaded library: for each GEMM ("gemm1", "gemm2") the
    rows and output columns of a tile, the stages of its operand ring, its
    tiles (k splits counted), the persistent blocks that walk over them (one
    an SM at most), its k splits and the CTAs of a cluster that share each
    weight tile. Needs the card."""
    out = (ctypes.c_int * 14)()
    err = kernels().sdt_geglu_ff_plan(m, c, inner, c if c_out is None else c_out, out)
    check(err, f"geglu_ff plan at {(m, c, inner, c_out)}")
    keys = ("rows", "cols", "stages", "tiles", "blocks", "splits", "cluster")
    return {"gemm1": dict(zip(keys, out[:7])), "gemm2": dict(zip(keys, out[7:]))}


def geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """GEGLU feed-forward over ``x [..., C]``; returns ``[..., C_out]``."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff: no path for device {x.device}")
    _check_inputs(x, w1, b1, w2, b2)
    c = x.shape[-1]
    c_out, inner = w2.shape
    x2 = x.reshape(-1, c).contiguous()
    w1, w2 = w1.contiguous(), w2.contiguous()
    b1 = b1.to(torch.float32).contiguous()
    b2 = b2.to(torch.float32).contiguous()
    m = x2.shape[0]
    h = torch.empty((m, inner), dtype=x.dtype, device=x.device)
    y = torch.empty((m, c_out), dtype=x.dtype, device=x.device)
    ws_elems = _workspace(x.device.index, m, c, inner, c_out)
    ws = torch.empty((ws_elems,), dtype=torch.float32, device=x.device) if ws_elems else None
    for name, t in (("x", x2), ("w1", w1), ("w2", w2)):
        if t.data_ptr() % 16:
            raise ValueError(f"geglu_ff: {name} is not 16-byte aligned")
    lib = kernels()
    with torch.cuda.device(x.device):
        err = lib.sdt_geglu_ff(
            x2.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), h.data_ptr(), ws.data_ptr() if ws is not None else None,
            y.data_ptr(), m, c, inner, c_out, stream_of(x))
    check(err, "geglu_ff")
    geglu_ff.launches += 1
    return y.view(*x.shape[:-1], c_out)


geglu_ff.launches = 0


class _GegluFF(torch.autograd.Function):
    """K2 forward; backward by recomputing the plain version (no kernel)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return geglu_ff(x, w1, b1, w2, b2)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            grads = iter(torch.autograd.grad(geglu_ff_plain(*inputs), wanted, dy))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def differentiable_geglu_ff(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                            w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """:func:`geglu_ff` with a gradient: through the autograd function where
    autograd records, else the inference wrapper, its inputs cast to
    autocast's dtype where autocast is on (fp32 master weights evaluated
    under no_grad, as validation and image logging do)."""
    inputs = (x, w1, b1, w2, b2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _GegluFF.apply(*inputs)
    if torch.is_autocast_enabled(x.device.type):
        dtype = torch.get_autocast_dtype(x.device.type)
        inputs = tuple(t.to(dtype) for t in inputs)
    return geglu_ff(*inputs)


def gelu_fast(g: torch.Tensor) -> torch.Tensor:
    """``sd_tpu``'s ``_gelu_fast_f32``: GELU through the degree-6 erf fit
    (max |err| 3.6e-4), clamped to +-1 beyond |x| = 3."""
    x = g * _SQRT_HALF
    a = torch.clamp(x.abs(), max=3.0)
    t = a * a
    acc = torch.full_like(t, _ERF_FAST[-1])
    for c in _ERF_FAST[-2::-1]:
        acc = acc * t + c
    r = torch.where(x.abs() > 3.0, torch.ones_like(a), a * acc)
    return 0.5 * g * (1.0 + torch.sign(x) * r)


def quantize_cols(w: torch.Tensor):
    """``sd_tpu``'s ``_quantize_cols`` on a torch ``Linear`` weight ``[out,
    in]``: per output channel (the columns of ``sd_tpu``'s ``[in, out]``),
    returning ``(q int8 [out, in], scale fp32 [out])``."""
    q, s = quantize_rows(w)
    return q, s.view(-1)


def interleave_runs(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The rows of ``a`` and ``g`` (``[I, ...]`` each, I a multiple of 64)
    in alternating runs of 64: rows ``128·u .. 128·u + 63`` are ``a``'s rows
    ``64·u ..``, the next 64 are ``g``'s same rows."""
    inner, run = a.shape[0], _INT8_RUN
    pair = torch.stack([a.reshape(inner // run, run, *a.shape[1:]),
                        g.reshape(inner // run, run, *g.shape[1:])], dim=1)
    return pair.reshape(2 * inner, *a.shape[1:])


def quantize_ff_weights(w1: torch.Tensor, w2: torch.Tensor, dtype: torch.dtype) -> dict:
    """The int8 tensors of the W8A8 FF: the value half, the gate half and the
    output weight, each cast to the compute ``dtype`` first (as ``sd_tpu``'s
    ``w.astype(x.dtype)``) and quantized per output channel; and, where
    inner is a multiple of 64, K4's first weight ``w1_q [2I, C]`` with its
    scales ``w1_s [2I]``: the value and gate halves' codes and scales
    interleaved in runs of 64 (:func:`interleave_runs`)."""
    inner = w2.shape[1]
    w1c = w1.to(dtype)
    w1a_q, w1a_s = quantize_cols(w1c[:inner])
    w1g_q, w1g_s = quantize_cols(w1c[inner:])
    w2_q, w2_s = quantize_cols(w2.to(dtype))
    out = dict(w1a_q=w1a_q, w1a_s=w1a_s, w1g_q=w1g_q, w1g_s=w1g_s, w2_q=w2_q, w2_s=w2_s)
    if inner % _INT8_RUN == 0:
        out.update(w1_q=interleave_runs(w1a_q, w1g_q), w1_s=interleave_runs(w1a_s, w1g_s))
    return out


def int8_ff_supported(mode, x: torch.Tensor, inner: int) -> bool:
    """The K4 site gate: the ``ff`` bucket on this tensor, inner >=
    ``_INT8_MIN_INNER`` (and lane-aligned), a width C that K4 takes
    (``int8_width_ok``: other widths take the bf16 FF), M >= 1024 and
    M % 256 == 0."""
    if not quant.int8_bucket_enabled(mode, "ff", x) or inner < _INT8_MIN_INNER or inner % 128:
        return False
    if not int8_width_ok(x.shape[-1]):
        return False
    m = x.numel() // x.shape[-1]
    return m >= 1024 and m % 256 == 0


def geglu_ff_int8_plain(x: torch.Tensor, qw: dict, b1: torch.Tensor,
                        b2: torch.Tensor) -> torch.Tensor:
    """K4's function in plain PyTorch: fp32 quantization, exact integer
    products, fp32 dequant, bias and fast GELU, h quantized per row in fp32."""
    inner = qw["w2_q"].shape[1]
    b1 = b1.float()
    xq, sx = quantize_rows(x)
    a = int8_matmul_exact(xq, qw["w1a_q"].t()) * (sx * qw["w1a_s"].float()) + b1[:inner]
    g = int8_matmul_exact(xq, qw["w1g_q"].t()) * (sx * qw["w1g_s"].float()) + b1[inner:]
    hq, sh = quantize_rows(a * gelu_fast(g))
    o = int8_matmul_exact(hq, qw["w2_q"].t()) * (sh * qw["w2_s"].float()) + b2.float()
    return o.to(x.dtype)


@functools.lru_cache(maxsize=256)
def _int8_plan(device: int, m: int, c: int, inner: int, c_out: int) -> tuple:
    """K4's 17 plan values at this shape on ``device`` (see :func:`int8_kernel_plan`)."""
    out = (ctypes.c_int * 17)()
    with torch.cuda.device(device):
        err = kernels().sdt_geglu_ff_int8_plan(m, c, inner, c_out, out)
    check(err, f"geglu_ff_int8 plan at {(m, c, inner, c_out)}")
    return tuple(out)


def int8_kernel_plan(m: int, c: int, inner: int, c_out: Optional[int] = None) -> dict:
    """K4's plans at ``x [m, c]``, inner ``inner`` (``c_out`` defaults to
    ``c``), from the loaded library: the first GEMM's (as K6's
    ``kernel_plan``: rows a block, columns a tile of the interleaved weight,
    stages, blocks, runs of F, tiles a block, shared memory bytes), the
    output GEMM's (rows and columns a block, columns a wgmma, h and W2
    stages, blocks, k splits, shared memory bytes) and the int32 scratch
    (row maxima, and the split's counters and sums). Needs the card."""
    v = _int8_plan(torch.cuda.current_device(), m, c, inner, c if c_out is None else c_out)
    first = ("rows", "cols", "stages", "blocks", "runs", "tiles_per_block", "smem_bytes")
    second = ("rows", "cols", "wgmma_cols", "h_stages", "w_stages", "blocks", "splits",
              "smem_bytes")
    return {"gemm1": dict(zip(first, v[:7])), "gemm2": dict(zip(second, v[7:15])),
            "scratch_ints": v[15] + (v[16] << 31)}


def _check_int8_inputs(x, qw, b1, b2) -> None:
    """The checks a CUDA call of K4 meets before its launch (also run on CPU
    tensors by the tests): bf16 x, the weights' shapes, C a multiple of 32
    and at most ``_MAX_INT8_C`` (a block keeps its rows of x quantized), inner
    of 128 (the output GEMM's k blocks), C_out of 8, x not empty."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"geglu_ff_int8: x is {x.dtype}; the card's path is bfloat16")
    c = x.shape[-1]
    c_out, inner = qw["w2_q"].shape
    shapes = {"w1a_q": (inner, c), "w1g_q": (inner, c), "w1a_s": (inner,),
              "w1g_s": (inner,), "w2_s": (c_out,), "w1_q": (2 * inner, c),
              "w1_s": (2 * inner,)}
    bad = [k for k, v in shapes.items() if k not in qw or tuple(qw[k].shape) != v]
    if bad or b1.shape != (2 * inner,) or b2.shape != (c_out,):
        raise ValueError(f"geglu_ff_int8: shapes of {bad or ['b1', 'b2']} do not match "
                         f"x {tuple(x.shape)}, inner {inner}, C_out {c_out}")
    if c % 32 or c > _MAX_INT8_C or inner % 128 or c_out % 8 or x.numel() == 0:
        raise ValueError(f"geglu_ff_int8: C={c} must be a multiple of 32 and at most "
                         f"{_MAX_INT8_C}, inner={inner} a multiple of 128, C_out={c_out} of 8, "
                         f"and x not empty")


def geglu_ff_int8(x: torch.Tensor, w1: Optional[torch.Tensor], b1: torch.Tensor,
                  w2: Optional[torch.Tensor], b2: torch.Tensor,
                  prequant: Optional[dict] = None) -> torch.Tensor:
    """The W8A8 GEGLU feed-forward over ``x [..., C]`` (torch Linear layout
    weights); ``prequant`` from :func:`quantize_ff_weights`, else the
    weights are quantized here. Returns ``[..., C_out]``."""
    check_no_grad("geglu_ff_int8", x, w1, b1, w2, b2)
    qw = prequant if prequant is not None else quantize_ff_weights(w1, w2, x.dtype)
    if x.device.type == "cpu":
        return geglu_ff_int8_plain(x, qw, b1, b2)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff_int8: no path for device {x.device}")
    _check_int8_inputs(x, qw, b1, b2)
    c = x.shape[-1]
    c_out, inner = qw["w2_q"].shape
    dev = x.device
    x2 = x.reshape(-1, c).contiguous()
    m = x2.shape[0]
    w1q = qw["w1_q"].contiguous()
    s1 = qw["w1_s"].to(torch.float32).reshape(-1).contiguous()
    w2q = qw["w2_q"].contiguous()
    s2 = qw["w2_s"].to(torch.float32).reshape(-1).contiguous()
    b1 = b1.to(torch.float32).contiguous()
    b2 = b2.to(torch.float32).contiguous()
    plan = _int8_plan(dev.index if dev.index is not None else torch.cuda.current_device(),
                      m, c, inner, c_out)
    h = torch.empty((m, inner), dtype=torch.float32, device=dev)
    scratch = torch.empty((plan[15] + (plan[16] << 31),), dtype=torch.int32, device=dev)
    y = torch.empty((m, c_out), dtype=x.dtype, device=dev)
    if x2.data_ptr() % 16 or w1q.data_ptr() % 16 or w2q.data_ptr() % 16:
        raise ValueError("geglu_ff_int8: x and the int8 weights must be 16-byte aligned")
    lib = kernels()
    with torch.cuda.device(dev):
        err = lib.sdt_geglu_ff_int8(
            x2.data_ptr(), w1q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
            s2.data_ptr(), b2.data_ptr(), h.data_ptr(), scratch.data_ptr(), y.data_ptr(), m, c,
            inner, c_out, stream_of(x))
    check(err, "geglu_ff_int8")
    geglu_ff_int8.launches += 1
    return y.view(*x.shape[:-1], c_out)


geglu_ff_int8.launches = 0
