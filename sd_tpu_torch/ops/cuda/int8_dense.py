"""K6: the W8A8 dense projection, ``out = q(x) Wqᵀ · (sx · sw) + b``.

Replaces the TPU kernel ``_kernel`` of ``sd_tpu/ops/pallas/int8_dense.py``
(entry ``int8_dense``), the int8 serving mode's ``proj`` bucket. The CUDA
source is ``sd_tpu_torch/csrc/int8_dense.cu`` on the int8 ``wgmma`` GEMM of
``int8_wgmma.cuh``, whose header says what bounds it on the H100: each row
of x is quantized once, by the block that keeps its codes for a run of F
(:func:`kernel_plan`).

The weight is in torch ``Linear`` layout ``[F, C]`` and quantized per output
channel (``prequant = (wq, sw)`` from load time, else here with the same
math). A row count that ``sd_tpu``'s ``_block_m`` finds no block for
(M >= 256 and not a multiple of 8) takes the plain product in the input
dtype instead, as ``sd_tpu`` does, so the two agree there too.

``int8_dense`` launches the kernel for a CUDA tensor and uses
:func:`int8_dense_plain` for a CPU tensor only; a CUDA tensor that is not
bf16, or a shape the kernel does not take (C a multiple of 32 up to 1280,
F of 8), raises. ``int8_dense.launches`` counts launches. Inference only:
it raises where autograd would record.
"""

from __future__ import annotations

from typing import Optional, Tuple

import ctypes
import functools

import torch
import torch.nn.functional as F

from sd_tpu_torch.ops.cuda._build import check, kernels, stream_of
from sd_tpu_torch.ops.quant import check_no_grad, int8_matmul_exact, quantize_rows

__all__ = ["int8_dense", "int8_dense_plain", "block_m", "kernel_plan"]

_DEFAULT_BM = 256
_MAX_C = 1280


def block_m(m: int, block: Optional[int] = None) -> Optional[int]:
    """``sd_tpu``'s row block for ``m`` rows, or None where there is none
    (then the product is not quantized)."""
    bm = min(block or _DEFAULT_BM, m)
    while bm > 8 and m % bm:
        bm //= 2
    return None if m % bm else bm


def int8_dense_plain(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                     b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function in plain PyTorch: per-row fp32 quantization of
    ``x [..., C]``, the exact integer product with ``wq [F, C]``, then
    ``o · (sx · sw) + b`` in fp32, in the dtype of ``x``."""
    xq, sx = quantize_rows(x)
    o = int8_matmul_exact(xq, wq.t()) * (sx * sw.float())
    if b is not None:
        o = o + b.float()
    return o.to(x.dtype)


def _plain_product(x, w, b):
    """``sd_tpu``'s fallback: the product in the input dtype, the bias in fp32."""
    out = F.linear(x, w.to(x.dtype))
    if b is not None:
        out = (out.float() + b.float()).to(x.dtype)
    return out


def _check_inputs(x, wq, sw, b):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int8_dense: x is {x.dtype}; the card's path is bfloat16")
    f, c = wq.shape
    if wq.dtype != torch.int8 or sw.shape != (f,) or x.shape[-1] != c:
        raise ValueError(f"int8_dense: x {tuple(x.shape)}, wq {wq.dtype} {tuple(wq.shape)}, "
                         f"sw {tuple(sw.shape)} do not match")
    if b is not None and b.shape != (f,):
        raise ValueError(f"int8_dense: bias {tuple(b.shape)}, expected {(f,)}")
    for name, t in (("wq", wq), ("sw", sw), ("b", b)):
        if t is not None and t.device != x.device:
            raise ValueError(f"int8_dense: {name} is on {t.device}, x on {x.device}")
    if c % 32 or c > _MAX_C or f % 8:
        raise ValueError(f"int8_dense: C={c} must be a multiple of 32 and at most {_MAX_C}, "
                         f"F={f} a multiple of 8")
    if x.numel() == 0:
        raise ValueError("int8_dense: empty input")


def kernel_plan(m: int, c: int, f: int) -> dict:
    """K6's plan at ``x [m, c]``, ``F = f``, from the loaded library: the
    rows a block keeps quantized, the columns of a tile, the stages of the
    weight ring, the blocks launched, the runs F is split into, the tiles a
    block walks and the block's shared memory. Needs the card."""
    out = (ctypes.c_int * 7)()
    check(kernels().sdt_int8_dense_plan(m, c, f, out), f"int8_dense plan at {(m, c, f)}")
    keys = ("rows", "cols", "stages", "blocks", "runs", "tiles_per_block", "smem_bytes")
    return dict(zip(keys, out))


@functools.lru_cache(maxsize=64)
def _zero_bias(f: int, device: torch.device) -> torch.Tensor:
    return torch.zeros(f, dtype=torch.float32, device=device)


def _launch(x2, wq, sw, bias) -> torch.Tensor:
    """The kernel on ``x2 [m, c]`` (checked inputs; ``bias`` or None)."""
    m, c = x2.shape
    f = wq.shape[0]
    if sw.dtype != torch.float32 or not sw.is_contiguous():
        sw = sw.float().contiguous()
    if bias is None:
        bias = _zero_bias(f, x2.device)
    elif bias.dtype != torch.float32 or not bias.is_contiguous():
        bias = bias.float().contiguous()
    out = torch.empty((m, f), dtype=x2.dtype, device=x2.device)
    for name, t in (("x", x2), ("wq", wq)):
        if t.data_ptr() % 16:
            raise ValueError(f"int8_dense: {name} is not 16-byte aligned")
    lib = kernels()
    with torch.cuda.device(x2.device):
        err = lib.sdt_int8_dense(x2.data_ptr(), wq.data_ptr(), sw.data_ptr(), bias.data_ptr(),
                                 out.data_ptr(), m, c, f, stream_of(x2))
    check(err, "int8_dense")
    int8_dense.launches += 1
    return out


def int8_dense(x: torch.Tensor, w: Optional[torch.Tensor], b: Optional[torch.Tensor] = None,
               prequant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``x @ wᵀ + b`` over ``x [..., C]`` with W8A8 quantization; ``w [F, C]``
    (may be None when ``prequant`` is given). Returns ``[..., F]``."""
    check_no_grad("int8_dense", x, w, b)
    wq, sw = prequant if prequant is not None else quantize_rows(w)
    sw = sw.reshape(-1)
    m = x.numel() // x.shape[-1]
    if block_m(m) is None:
        if w is None:
            raise ValueError(f"int8_dense: {m} rows take the plain product, which needs w")
        return _plain_product(x, w, b)
    if x.device.type == "cpu":
        return int8_dense_plain(x, wq, sw, b)
    if x.device.type != "cuda":
        raise ValueError(f"int8_dense: no path for device {x.device}")
    _check_inputs(x, wq, sw, b)
    c = x.shape[-1]
    out = _launch(x.reshape(-1, c).contiguous(), wq.contiguous(), sw, b)
    return out.view(*x.shape[:-1], wq.shape[0])


int8_dense.launches = 0
