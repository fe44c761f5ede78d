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
``sd_tpu_torch/csrc/geglu_ff_int8.cu``. ``geglu_ff_int8`` quantizes x and h
per row and reads weights quantized per output channel (``quantize_cols``,
at load time or inline with the same math); ``geglu_ff_int8.launches``
counts its calls that launched. The GELU there is always ``sd_tpu``'s
short erf polynomial (:func:`gelu_fast`). :func:`int8_ff_supported` is
the site gate: the ``ff`` bucket, inner >= ``_INT8_MIN_INNER`` and the
fused FF's row rule (M >= 1024, M % 256 == 0); other sites keep K2.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from sd_tpu_torch.ops import quant
from sd_tpu_torch.ops.cuda._build import check, kernels, stream_of
from sd_tpu_torch.ops.quant import check_no_grad, int8_matmul_exact, quantize_rows

__all__ = ["geglu_ff", "geglu_ff_plain", "differentiable_geglu_ff", "geglu_ff_int8",
           "geglu_ff_int8_plain", "quantize_cols", "quantize_ff_weights", "gelu_fast",
           "int8_ff_supported", "kernel_plan"]

# sd_tpu's _ERF_FAST: erf(x) ~ x * P6(x^2) on |x| <= 3, coefficients low to high
_ERF_FAST = (
    1.12646408, -0.366942461, 0.0998401577, -0.0183764236, 0.00211666563,
    -0.000135903813, 3.68124527e-06,
)
_SQRT_HALF = 0.7071067811865476
# the int8 FF only where sd_tpu measured it faster: inner 2560 and 5120
_INT8_MIN_INNER = 2560
_MAX_INT8_C = 2560


def geglu_ff_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch: fp32 products, exact-erf GELU in
    fp32, h rounded to the input dtype before the output projection."""
    inner = w2.shape[1]
    with torch.autocast(x.device.type, enabled=False):
        s = F.linear(x.float(), w1.float(), b1.float())
        a, g = s[..., :inner], s[..., inner:]
        h = (a * F.gelu(g)).to(x.dtype)
        return F.linear(h.float(), w2.float(), b2.float()).to(x.dtype)


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
    autograd records, else the inference wrapper."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _GegluFF.apply(x, w1, b1, w2, b2)
    return geglu_ff(x, w1, b1, w2, b2)


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


def quantize_ff_weights(w1: torch.Tensor, w2: torch.Tensor, dtype: torch.dtype) -> dict:
    """The six int8 tensors K4 reads: the value half, the gate half and the
    output weight, each cast to the compute ``dtype`` first (as ``sd_tpu``'s
    ``w.astype(x.dtype)``) and quantized per output channel."""
    inner = w2.shape[1]
    w1c = w1.to(dtype)
    w1a_q, w1a_s = quantize_cols(w1c[:inner])
    w1g_q, w1g_s = quantize_cols(w1c[inner:])
    w2_q, w2_s = quantize_cols(w2.to(dtype))
    return dict(w1a_q=w1a_q, w1a_s=w1a_s, w1g_q=w1g_q, w1g_s=w1g_s, w2_q=w2_q, w2_s=w2_s)


def int8_ff_supported(mode, x: torch.Tensor, inner: int) -> bool:
    """The K4 site gate: the ``ff`` bucket on this tensor, inner >=
    ``_INT8_MIN_INNER`` (and lane-aligned), M >= 1024 and M % 256 == 0."""
    if not quant.int8_bucket_enabled(mode, "ff", x) or inner < _INT8_MIN_INNER or inner % 128:
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
    c = x.shape[-1]
    c_out, inner = qw["w2_q"].shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"geglu_ff_int8: x is {x.dtype}; the card's path is bfloat16")
    shapes = {"w1a_q": (inner, c), "w1g_q": (inner, c), "w1a_s": (inner,),
              "w1g_s": (inner,), "w2_s": (c_out,)}
    bad = [k for k, v in shapes.items() if tuple(qw[k].shape) != v]
    if bad or b1.shape != (2 * inner,) or b2.shape != (c_out,):
        raise ValueError(f"geglu_ff_int8: shapes of {bad or ['b1', 'b2']} do not match "
                         f"x {tuple(x.shape)}, inner {inner}, C_out {c_out}")
    if c % 16 or inner % 16 or c > _MAX_INT8_C or x.numel() == 0:
        raise ValueError(f"geglu_ff_int8: C={c} and inner={inner} must be multiples of 16, "
                         f"C at most {_MAX_INT8_C}, and x not empty")
    dev = x.device
    x2 = x.reshape(-1, c).contiguous()
    m = x2.shape[0]
    w = {k: v.contiguous() for k, v in qw.items()}
    for k in ("w1a_s", "w1g_s", "w2_s"):
        w[k] = w[k].to(torch.float32).reshape(-1)
    b1 = b1.to(torch.float32).contiguous()
    b2 = b2.to(torch.float32).contiguous()
    h = torch.empty((m, inner), dtype=torch.float32, device=dev)
    rowmax = torch.zeros((m,), dtype=torch.float32, device=dev)
    hq = torch.empty((m, inner), dtype=torch.int8, device=dev)
    sh = torch.empty((m,), dtype=torch.float32, device=dev)
    y = torch.empty((m, c_out), dtype=x.dtype, device=dev)
    if x2.data_ptr() % 16 or any(w[k].data_ptr() % 16 for k in ("w1a_q", "w1g_q", "w2_q")):
        raise ValueError("geglu_ff_int8: x and the int8 weights must be 16-byte aligned")
    lib = kernels()
    with torch.cuda.device(dev):
        err = lib.sdt_geglu_ff_int8(
            x2.data_ptr(), w["w1a_q"].data_ptr(), w["w1a_s"].data_ptr(), b1.data_ptr(),
            w["w1g_q"].data_ptr(), w["w1g_s"].data_ptr(), b1.data_ptr() + 4 * inner,
            w["w2_q"].data_ptr(), w["w2_s"].data_ptr(), b2.data_ptr(), h.data_ptr(),
            rowmax.data_ptr(), hq.data_ptr(), sh.data_ptr(), y.data_ptr(), m, c, inner, c_out,
            stream_of(x))
    check(err, "geglu_ff_int8")
    geglu_ff_int8.launches += 1
    return y.view(*x.shape[:-1], c_out)


geglu_ff_int8.launches = 0
