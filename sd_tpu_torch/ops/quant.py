"""The W8A8 int8 serving mode (port of ``sd_tpu/ops/quant.py``).

Inference only and off by default. The mode is a set of buckets, parsed once
from the ``SD_TPU_INT8`` grammar of ``sd_tpu`` when a pipeline is built and
then held on the modules (``Conv3x3``, ``FeedForward``, ``CrossAttention``,
``VAEAttnBlock``) by :func:`set_int8_mode`; no forward pass reads the
environment.

``SD_TPU_INT8`` / ``int8=`` values:

    0/off (default)   bf16 everywhere
    1/all             convs + GEGLU-FF (K4) + int8 QK^T attention (K5)
    conv[,ff][,attn][,attn_pv][,proj]
                      an explicit bucket list; ``attn_pv`` also quantizes
                      P.V where the head dim is at least 256 (the VAE
                      mid-block); ``proj`` sends the attention projections
                      through K6 (``ops/cuda/int8_dense.py``)
    <N>               the conv bucket only, at sites with H*W >= N

A site runs int8 only where :func:`int8_bucket_enabled` says so: its bucket
is in the mode, the activations are bf16, and they lie on a CUDA device
(where ``sd_tpu`` asks for the TPU backend).

Scheme, as in ``sd_tpu``: symmetric int8 with the scale floored at 1e-12,
round half to even, clipped to +-127; per output channel for weights, per
row for activations (per tensor over the whole batch for the conv). The
conv is not a TPU kernel in ``sd_tpu`` (XLA computes its int8 convolution),
so the port computes it with stock PyTorch: im2col of the int8 codes, then
``torch._int_mm`` (int8 -> int32), then the fp32 dequant and bias.

Weights the mode reads are quantized once, at load time
(:func:`prequantize_weights`), with the same math as the inline path, bit
for bit; a module whose weights were replaced since (``load_state_dict``,
``.to()``) quantizes them again before it serves them (:class:`Int8Weights`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Int8Mode", "INT8_OFF", "BUCKETS", "parse_int8", "int8_device_ok",
           "int8_bucket_enabled", "int8_enabled", "int8_mode_label", "quantize_rows",
           "quantize_conv_kernel", "int8_conv3x3", "int8_conv3x3_plain", "int8_matmul_exact",
           "Int8Weights", "set_int8_mode", "prequantize_weights",
           "check_no_grad"]

BUCKETS = ("conv", "ff", "attn", "attn_pv", "proj")
# "all": the buckets sd_tpu ships in its serving mode
_ALL = frozenset(("conv", "ff", "attn"))
# im2col bytes per chunk of images in the int8 conv on the card
_IM2COL_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class Int8Mode:
    """The buckets asked for, and the conv bucket's H*W threshold (None = every site)."""

    buckets: frozenset = frozenset()
    conv_threshold: Optional[int] = None

    def __bool__(self) -> bool:
        return bool(self.buckets)


INT8_OFF = Int8Mode()


def parse_int8(spec: Union[None, str, Int8Mode] = None) -> Int8Mode:
    """The mode of ``spec`` in ``SD_TPU_INT8``'s grammar; None reads the
    variable (unset = off). An unknown bucket raises ``ValueError``."""
    if isinstance(spec, Int8Mode):
        return spec
    if spec is None:
        spec = os.environ.get("SD_TPU_INT8", "0")
    env = str(spec).strip().lower()
    if env in ("0", "off", ""):
        return INT8_OFF
    if env in ("1", "all"):
        return Int8Mode(_ALL)
    try:
        threshold = int(env)
    except ValueError:
        pass
    else:
        return Int8Mode(frozenset(("conv",)), threshold if threshold > 1 else None)
    toks = frozenset(t.strip() for t in env.split(",") if t.strip())
    unknown = toks - frozenset(BUCKETS)
    if unknown:
        raise ValueError(f"SD_TPU_INT8: unknown buckets {sorted(unknown)} "
                         f"(valid: {BUCKETS}, 'all', a threshold int, or 0)")
    return Int8Mode(toks)


def int8_device_ok(x: torch.Tensor) -> bool:
    """Where int8 may run: bf16 activations on a CUDA device."""
    return x.dtype == torch.bfloat16 and x.device.type == "cuda"


def int8_bucket_enabled(mode: Int8Mode, bucket: str, x: torch.Tensor) -> bool:
    """The dispatch gate shared by every bucket (``sd_tpu``'s
    ``int8_bucket_enabled``, with the CUDA device for the TPU)."""
    return bucket in mode.buckets and int8_device_ok(x)


def int8_enabled(mode: Int8Mode, x: torch.Tensor) -> bool:
    """The gate of the int8 conv at an NCHW input ``x``."""
    if not int8_bucket_enabled(mode, "conv", x):
        return False
    thr = mode.conv_threshold
    return thr is None or x.shape[-2] * x.shape[-1] >= thr


def int8_mode_label(mode: Int8Mode, device, dtype: torch.dtype = torch.bfloat16) -> str:
    """The label of what runs for activations of ``dtype`` on ``device``,
    from the same predicate as the dispatch: "bf16" where the gate keeps
    int8 off."""
    probe = torch.empty(0, dtype=dtype, device=device)
    active = sorted(b for b in BUCKETS if int8_bucket_enabled(mode, b, probe))
    if not active:
        return "bf16"
    if mode.conv_threshold and "conv" in active:
        active[active.index("conv")] = f"conv>={mode.conv_threshold}"
    return "bf16+int8[" + ",".join(active) + "]"


def check_no_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where autograd would record through an int8 path: ``round``
    has a zero gradient almost everywhere, and there is no straight-through
    estimator."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the int8 serving mode is inference-only (round() has a "
                           f"zero gradient almost everywhere); call it under torch.no_grad() "
                           f"or torch.inference_mode()")


def quantize_rows(x: torch.Tensor, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization along ``dim`` (fp32 math).

    Returns ``(q int8, scale fp32)``, the scale shaped like ``x`` with
    ``dim`` reduced to 1, so that ``q * scale ~= x``.
    """
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=dim, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / s), -127.0, 127.0).to(torch.int8)
    return q, s


def quantize_conv_kernel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 quantization of an OIHW conv weight:
    ``(kq int8 OIHW, sw fp32 [Cout])``, ``sd_tpu``'s math on its HWIO kernel."""
    kq, sw = quantize_rows(weight.flatten(1))
    return kq.view(weight.shape), sw.view(-1)


def _quantize_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scale for the whole tensor (the conv's activations, the batch
    included: a guided batch's halves share it)."""
    xf = x.float()
    sx = torch.clamp(xf.abs().amax() / 127.0, min=1e-12)
    return torch.clamp(torch.round(xf / sx), -127.0, 127.0).to(torch.int8), sx


def int8_matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of int8 codes, exactly, as float32: in float32 where no sum
    can pass 2^24, else in float64 and rounded once (as int32 -> fp32 is)."""
    if a.shape[-1] * 127 * 127 < 2**24:
        return a.float() @ b.float()
    return (a.double() @ b.double()).float()


def int8_conv3x3_plain(xq: torch.Tensor, sx: torch.Tensor, kq: torch.Tensor,
                       sw: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype
                       ) -> torch.Tensor:
    """The int8 conv of the codes in plain PyTorch: ``F.conv2d`` in float64
    on the integers (exact: |sum| <= 9 * Cin * 127^2 < 2^53), then
    ``y * (sx * sw) + bias`` in fp32."""
    y = F.conv2d(xq.double(), kq.double(), padding=1).float()
    return (y * (sx * sw)[:, None, None] + bias.float()[:, None, None]).to(out_dtype)


def _int8_conv_card(xq, sx, kq, sw, bias, out_dtype):
    """im2col of the codes in chunks of images, ``torch._int_mm`` (cuBLASLt,
    int8 -> int32), fp32 dequant + bias. K = 9 Cin and N = Cout are padded
    with zeros to multiples of 8, as ``_int_mm`` asks."""
    b, cin, h, w = xq.shape
    cout = kq.shape[0]
    k, kp, np_ = 9 * cin, -(-9 * cin // 8) * 8, -(-cout // 8) * 8
    wmat = torch.zeros((np_, kp), dtype=torch.int8, device=xq.device)
    wmat[:cout, :k] = kq.permute(0, 2, 3, 1).reshape(cout, k)  # (ky, kx, c) order
    scale = (sx * sw).float()
    out = torch.empty((b, cout, h, w), dtype=out_dtype, device=xq.device)
    padded = torch.zeros((b, h + 2, w + 2, cin), dtype=torch.int8, device=xq.device)
    padded[:, 1:h + 1, 1:w + 1] = xq.permute(0, 2, 3, 1)
    per_image = h * w * kp
    step = max(1, _IM2COL_CHUNK_BYTES // per_image)
    for i in range(0, b, step):
        part = padded[i:i + step]
        cols = torch.zeros((part.shape[0], h, w, kp), dtype=torch.int8, device=xq.device)
        for ky in range(3):
            for kx in range(3):
                tap = 3 * ky + kx
                cols[..., tap * cin:(tap + 1) * cin] = part[:, ky:ky + h, kx:kx + w]
        # _int_mm wants more than 16 rows; every image here has h * w >= 64
        y = torch._int_mm(cols.view(-1, kp), wmat.t())[:, :cout]
        y = y.float() * scale + bias.float()
        out[i:i + step] = y.view(part.shape[0], h, w, cout).permute(0, 3, 1, 2)
    return out


def int8_conv3x3(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 prequant: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """W8A8 3x3 stride-1 conv with padding 1 on NCHW ``x`` and an OIHW
    ``weight``: per-tensor activation scale, per-output-channel weight
    scales (``prequant`` = ``(kq, sw)`` from :func:`quantize_conv_kernel`,
    else quantized here), result in the dtype of ``x``. On the card the
    product runs through ``torch._int_mm``; on the CPU through
    :func:`int8_conv3x3_plain`. ``int8_conv3x3.launches`` counts the card's
    calls."""
    check_no_grad("int8_conv3x3", x, weight, bias)
    xq, sx = _quantize_tensor(x)
    kq, sw = prequant if prequant is not None else quantize_conv_kernel(weight)
    if x.device.type == "cpu":
        return int8_conv3x3_plain(xq, sx, kq, sw, bias, x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv3x3: no path for device {x.device}")
    if x.ndim != 4 or weight.shape[1:] != (x.shape[1], 3, 3):
        raise ValueError(f"int8_conv3x3: x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)} do not match")
    out = _int8_conv_card(xq, sx, kq, sw, bias, x.dtype)
    int8_conv3x3.launches += 1
    return out


int8_conv3x3.launches = 0


class Int8Weights:
    """Mixin of a module whose int8 bucket reads quantized weights: it
    names its bucket, the weights the int8 copies come from, and how to
    quantize them. :meth:`int8_weights` quantizes at first use (or at load
    time, :func:`prequantize_weights`) and again whenever those weights were
    replaced (new storage, dtype or device) or changed in place (their
    version counters), so stale int8 weights are never served."""

    int8 = INT8_OFF
    int8_bucket = ""

    def int8_sources(self) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def int8_quantize(self) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def int8_weights(self) -> Dict[str, torch.Tensor]:
        key = tuple((t.data_ptr(), t.dtype, t.device, t._version) for t in self.int8_sources())
        cache = getattr(self, "_int8_cache", None)
        if cache is None or cache[0] != key:
            with torch.no_grad():
                cache = (key, self.int8_quantize())
            self._int8_cache = cache
        return cache[1]


def set_int8_mode(module: nn.Module, mode: Union[None, str, Int8Mode]) -> Int8Mode:
    """Hold ``mode`` on every int8-capable submodule of ``module`` (those
    with an ``int8`` attribute); returns the parsed mode."""
    mode = parse_int8(mode)
    for m in module.modules():
        if hasattr(type(m), "int8"):
            m.int8 = mode
    return mode


def prequantize_weights(module: nn.Module) -> int:
    """Quantize, now, every weight that the int8 mode held on ``module``'s
    submodules will read (``sd_tpu``'s load-time ``prequantize_weights``
    overlay, kept on the modules). Returns the number of modules quantized."""
    n = 0
    for m in module.modules():
        if isinstance(m, Int8Weights) and m.int8_bucket in m.int8.buckets:
            m.int8_weights()
            n += 1
    return n
