"""K1: flash attention on ``[B, N, H, D]`` tensors, and K3, its backward.

K1 replaces the TPU kernel of ``sd_tpu/ops/pallas/flash_attention.py``
(``_kernel_chunked``/``_kernel``/``_kernel_allheads`` through ``_fwd_bhnd``,
entry ``flash_attention``); its CUDA source is
``sd_tpu_torch/csrc/flash_attention.cu``. K3 replaces ``_bwd_kernel`` through
``_bwd_bhnd_pallas``; its source is ``sd_tpu_torch/csrc/flash_attention_bwd.cu``.
Each source's header says what bounds it on the H100 and what its design
does about that.

- ``flash_attention`` (K1) and ``flash_attention_bwd`` (K3) launch their
  kernels for a CUDA tensor and use :func:`flash_attention_plain` /
  :func:`flash_attention_bwd_plain` for a CPU tensor only. The card's path is
  bf16: a CUDA tensor of another dtype raises, as does any shape a kernel
  does not take (``ops/attention.py::takes_kernel`` sends the card's other
  dtypes to the plain versions before they get here).
  ``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
  kernel launches (one per call).
  :func:`kernel_plan` reads each kernel's launch plan from the library.
  K1 takes head dims that are multiples of 8 up to 1024 (``K1_MAX_HEAD_DIM``:
  14 plans; above 576 the split plan, whose blocks own slices of 256 of O's
  columns, for the first-stage extras' one-head sites up to d = 1024 and
  cin256-v2's d = 960); K3 up to 512 (``K3_MAX_HEAD_DIM``), and K5 up to 512
  (``K5_MAX_HEAD_DIM``).
- :func:`differentiable_flash_attention` is the entry point for code that
  may need gradients: where autograd records, it runs a
  ``torch.autograd.Function`` whose forward is K1 (with the row log-sum-exp
  saved) and whose backward follows ``sd_tpu``'s ``_flash_bhnd_bwd``: K3 when
  Nk > 256 and Nq is a multiple of 256, the plain backward otherwise
  (:func:`uses_bwd_kernel`, which refuses a head dim above K3's 512 where
  ``sd_tpu`` would run its backward kernel).

K5, the int8 serving mode's attention (``attn``: int8 QKᵀ, mode "qk";
``attn_pv``: int8 P·V too, mode "qkpv"), replaces ``_kernel_chunked_int8``
through ``_fwd_bhnd``; its source is
``sd_tpu_torch/csrc/flash_attention_int8.cu``. :func:`resolve_int8` is
``sd_tpu``'s ``_resolve_int8`` rule; :func:`flash_attention_int8` launches
the kernel for a CUDA tensor (``flash_attention_int8.launches``; of them
``.pv_launches`` in "qkpv") and uses
:func:`flash_attention_int8_plain`, which walks 1024-key chunks in the TPU
kernel's order, for a CPU tensor only. It has no backward and raises where
autograd would record. :func:`int8_scratch_shapes` gives the codes and
scales the wrapper allocates for the kernel (V's codes transposed, keys
contiguous per feature), and ``kernel_plan(d, "K5 qk" | "K5 qkpv", (B, N,
H))`` its launch plan at a shape.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from sd_tpu_torch.ops import quant
from sd_tpu_torch.ops.cuda._build import check, kernels, stream_of
from sd_tpu_torch.ops.quant import check_no_grad, int8_matmul_exact, quantize_rows

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_lse_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "differentiable_flash_attention", "resolve_int8", "flash_attention_int8",
           "flash_attention_int8_plain", "int8_padded_dim", "int8_scratch_shapes",
           "kernel_plan", "uses_bwd_kernel", "flash_shape_supported", "K1_MAX_HEAD_DIM",
           "K3_MAX_HEAD_DIM", "K5_MAX_HEAD_DIM", "K1_COVERAGE_ITEM", "K3_COVERAGE_ITEM"]

# the widest head dim each kernel takes: K1's split plan reaches the
# first-stage extras' d = 1024 sites; K3's and K5's stop at the VAE
# mid-block's 512
K1_MAX_HEAD_DIM = 1024
K3_MAX_HEAD_DIM = 512
K5_MAX_HEAD_DIM = 512
# what a refusal of a head dim past those names: ROADMAP.md's open coverage
K1_COVERAGE_ITEM = "ROADMAP.md's open kernel coverage 'K1 above d = 1024'"
K3_COVERAGE_ITEM = "ROADMAP.md's open kernel coverage 'K3 above d = 512'"
# sd_tpu's flash_supported shape rule: the rows its kernel takes
_FLASH_MIN_N, _FLASH_MAX_N, _FLASH_N_MULTIPLE = 128, 4096, 128
# sd_tpu's backward dispatch (_flash_bhnd_bwd): the kernel above 256 keys,
# when the queries tile by 256; the plain backward otherwise
_SMALL_KV = 256
_BLOCK_Q_BWD = 256
_LOG2E = math.log2(math.e)
# the int8 kernel's key chunk (part of its function in "qkpv"), and the
# shortest row it engages at (sd_tpu measured int8 slower below it)
INT8_CHUNK = 1024
_INT8_MIN_KV = 2048


def _plain_scope(t: torch.Tensor):
    """The plain versions compute their fp32 islands in fp32 under autocast too."""
    return torch.autocast(t.device.type, enabled=False)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same function in plain PyTorch: fp32 logits and softmax, the
    probabilities cast to the input dtype before the product with ``v``.

    ``mask`` (True = attend, broadcast to ``[B, H, Nq, Nk]``) is for the
    callers the kernel does not serve, such as CLIP's causal attention.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    with _plain_scope(q):
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        if mask is not None:
            logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
        weights = torch.softmax(logits, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """K1's row statistic in plain PyTorch: fp32 ``[B, H, Nq]`` log-sum-exp
    in base 2 of the logits times ``scale``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    with _plain_scope(q):
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        return torch.logsumexp(logits, dim=-1) * math.log2(math.e)


def flash_attention_bwd_plain(q, k, v, o, do, scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV of :func:`flash_attention_plain` in plain PyTorch, in the
    token-major layout; mirrors ``sd_tpu``'s ``_bwd_bhnd_xla``: fp32 logits,
    softmax and dP, the probabilities and dS rounded to the input dtype."""
    with _plain_scope(q):
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale, -1)
        dv = torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype), do)
        dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]  # [B, H, Nq, 1]
        ds = (p * (dp - delta) * scale).to(q.dtype)
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, k)
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, q)
    return dq, dk, dv


def _check_inputs(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the card's "
                            f"path is bfloat16")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on "
                             f"{q.device}")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be [B, N, H, D], got "
                             f"{tuple(t.shape)}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte aligned")
    b, nq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if d % 8 or d > K1_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple of 8 "
                         f"and at most {K1_MAX_HEAD_DIM}")
    if min(b, nq, k.shape[1], h) == 0:
        raise ValueError("flash_attention: empty input")


def _check_bwd_inputs(q, k, v, o, do, lse):
    _check_inputs(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.dtype != torch.bfloat16 or t.device != q.device or t.shape != q.shape:
            raise ValueError(f"flash_attention_bwd: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; q is {q.dtype} {tuple(q.shape)} on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} is not 16-byte aligned")
    b, nq, h, d = q.shape
    if lse is None or lse.dtype != torch.float32 or lse.shape != (b, h, nq):
        raise ValueError(f"flash_attention_bwd: lse must be float32 {(b, h, nq)}")
    if d > K3_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: head dim {d} above {K3_MAX_HEAD_DIM}")


def _check_scale(scale: float, what: str) -> None:
    # the kernels take the row max of the raw logits before scaling them
    if not scale > 0:
        raise ValueError(f"{what}: scale must be positive, got {scale}")


def kernel_plan(d: int, which: str = "K1", shape: Optional[Tuple[int, int, int]] = None
                ) -> dict:
    """The launch plan of K1 ("K1"), of one of K3's passes ("K3 dK/dV",
    "K3 dQ") at head dim ``d``, or of K5 ("K5 qk", "K5 qkpv") at head dim
    ``d`` and ``shape`` = (B, N, H), from the loaded library: the rows a
    block owns, the rows of the tile it streams, threads and shared-memory
    bytes per block, and the blocks that fit on one SM; for K1 also the
    slices of O's columns over which a row tile's blocks split (1 but in
    the split plan). Needs the card."""
    out = (ctypes.c_int * 6)()
    lib = kernels()
    if which == "K1":
        err = lib.sdt_flash_plan(d, out)
    elif which.startswith("K5"):
        err = lib.sdt_flash_int8_plan(*shape, d, int(which == "K5 qkpv"), out)
    else:
        err = lib.sdt_flash_bwd_plan(d, {"K3 dK/dV": 1, "K3 dQ": 2}[which], out)
    check(err, f"{which} plan at d={d}")
    names = ("rows", "tile", "threads", "smem_bytes", "blocks_per_sm")
    return dict(zip(names + (("slices",) if which == "K1" else ()), out))


def _launch_forward(q, k, v, scale: float, with_lse: bool):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_inputs(q, k, v)
    _check_scale(scale, "flash_attention")
    b, nq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device) if with_lse else None
    lib = kernels()
    with torch.cuda.device(q.device):
        err = lib.sdt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, nq, k.shape[1], h, d, float(scale),
            stream_of(q))
    check(err, "flash_attention")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q kᵀ · scale) v over ``[B, N, H, D]``; ``scale`` defaults to
    ``D ** -0.5``. Returns ``[B, Nq, H, D]`` in the dtype of ``q``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no path for device {q.device}")
    return _launch_forward(q, k, v, scale, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, do, lse: Optional[torch.Tensor], scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dQ, dK, dV of ``o = flash_attention(q, k, v, scale)`` for the output
    gradient ``do``; ``lse`` is K1's row log-sum-exp (unused on the CPU).
    Each gradient has the shape and dtype of its input."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no path for device {q.device}")
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    _check_bwd_inputs(q, k, v, o, do, lse)
    _check_scale(scale, "flash_attention_bwd")
    b, nq, h, d = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
    lib = kernels()
    with torch.cuda.device(q.device):
        err = lib.sdt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, nq, k.shape[1], h, d, float(scale), stream_of(q))
    check(err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


def flash_shape_supported(nq: int, nk: int) -> bool:
    """``sd_tpu``'s ``flash_supported`` shape rule (its platform and mask
    aside): self-attention (Nk == Nq) with 128 <= N <= 4096 and N a multiple
    of 128. It has no head-dim condition."""
    return (nk == nq and _FLASH_MIN_N <= nq <= _FLASH_MAX_N
            and nq % _FLASH_N_MULTIPLE == 0)


def uses_bwd_kernel(nq: int, nk: int, d: int) -> bool:
    """``sd_tpu``'s ``_flash_bhnd_bwd`` rule: the backward kernel where
    Nk > 256 and Nq % 256 == 0, the plain backward otherwise. Where the
    rule asks for the kernel at a head dim above K3's 512, it raises: the
    port has no backward kernel there, and the plain backward would hide
    the missing coverage."""
    if not (nk > _SMALL_KV and nq % _BLOCK_Q_BWD == 0):
        return False
    if d > K3_MAX_HEAD_DIM:
        raise ValueError(f"flash attention backward at Nq={nq}, Nk={nk}, head dim {d}: "
                         f"sd_tpu runs its backward kernel there and K3 takes head dims up to "
                         f"{K3_MAX_HEAD_DIM}; see {K3_COVERAGE_ITEM}")
    return True


class _FlashAttention(torch.autograd.Function):
    """K1 forward (saving the row log-sum-exp), K3 or the plain backward."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.bfloat16)
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cuda":
            out, lse = _launch_forward(q, k, v, scale, with_lse=True)
        else:
            out, lse = flash_attention(q, k, v, scale), None
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if uses_bwd_kernel(q.shape[1], k.shape[1], q.shape[-1]):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, do, ctx.scale)
        return dq, dk, dv, None


def differentiable_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention` with a gradient: through the autograd function
    where autograd records (grad enabled and an input requires grad), else
    the inference wrapper, which writes no row statistics."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, float(scale))
    return flash_attention(q, k, v, scale)


def resolve_int8(int8, q: torch.Tensor, k: torch.Tensor, masked: bool = False) -> str:
    """``sd_tpu``'s ``_resolve_int8``: the int8 mode of one attention call.

    ``int8`` is "off"/"qk"/"qkpv", or a serving mode (``quant.Int8Mode``):
    ``attn_pv`` gives "qkpv" at head dims >= 256 and "qk" below, ``attn``
    gives "qk", each only where the bucket's gate passes for ``q``. Any mode
    resolves to "off" unless the row is full and unmasked (Nq == Nk),
    Nk >= 2048 and Nk a multiple of the 1024-key chunk, and the head dim is
    one K5 takes (up to 512): a wider head takes bf16 K1.
    """
    if isinstance(int8, quant.Int8Mode):
        if quant.int8_bucket_enabled(int8, "attn_pv", q):
            int8 = "qkpv" if q.shape[-1] >= 256 else "qk"
        elif quant.int8_bucket_enabled(int8, "attn", q):
            int8 = "qk"
        else:
            int8 = "off"
    if int8 not in ("off", "qk", "qkpv"):
        raise ValueError(f"int8 attention mode {int8!r}: expected off, qk or qkpv")
    nq, nk = q.shape[1], k.shape[1]
    if (masked or nq != nk or nk < _INT8_MIN_KV or nk % INT8_CHUNK
            or int8_padded_dim(q.shape[-1]) == 0):
        return "off"
    return int8


def flash_attention_int8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float, mode: str) -> torch.Tensor:
    """K5's function in plain PyTorch, in ``_kernel_chunked_int8``'s order:
    Q per row and K per key quantized in fp32, exact integer logits times
    ``sq * scale * log2 e * sk``, an exp2 online softmax over 1024-key
    chunks; "qk" casts P to V's dtype for P·V, "qkpv" quantizes P to
    round(P·127) against the max after each chunk and V per feature over the
    chunk. ``[B, N, H, D]`` in, the dtype of ``q`` out."""
    nk = k.shape[1]
    with torch.autocast(q.device.type, enabled=False):
        qq, sq = quantize_rows(q.transpose(1, 2))           # [B, H, Nq, D], [B, H, Nq, 1]
        kq, sk = quantize_rows(k.transpose(1, 2))           # [B, H, Nk, D], [B, H, Nk, 1]
        vt = v.transpose(1, 2)
        sq_post = sq * (scale * _LOG2E)
        sk = sk.transpose(-1, -2)                           # [B, H, 1, Nk]
        m = torch.full(sq.shape, -math.inf, device=q.device)
        l = torch.zeros(sq.shape, device=q.device)
        acc = torch.zeros(qq.shape, device=q.device)
        for c0 in range(0, nk, INT8_CHUNK):
            sl = slice(c0, c0 + INT8_CHUNK)
            s = int8_matmul_exact(qq, kq[..., sl, :].transpose(-1, -2)) * sq_post * sk[..., sl]
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp2(s - m_new)
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            vc = vt[..., sl, :]
            if mode == "qkpv":
                pq = torch.round(p * 127.0).to(torch.int8)
                vq, sv = quantize_rows(vc, dim=-2)          # per feature: [B, H, 1, D]
                acc = acc * corr + int8_matmul_exact(pq, vq) * (sv / 127.0)
            else:
                acc = acc * corr + p.to(vc.dtype).float() @ vc.float()
            m = m_new
        return (acc / l).to(q.dtype).transpose(1, 2)


def int8_padded_dim(d: int) -> int:
    """The head dim K5 pads the contraction to (0: a head dim it does not
    take): 48 up to d = 48, 512 above, d a multiple of 8 up to 512 (K5's own
    cap, below K1's). The library's ``sdt_flash_int8_padded_dim`` is the
    same rule."""
    if d <= 0 or d % 8 or d > K5_MAX_HEAD_DIM:
        return 0
    return 48 if d <= 48 else 512


def _check_int8_inputs(q, k, v) -> int:
    """The checks a CUDA tensor meets before K5 launches, past
    ``_check_inputs``: self-attention, N a multiple of the chunk, a head dim
    K5 pads; returns the padded head dim."""
    _check_inputs(q, k, v)
    b, n, h, d = q.shape
    dp = int8_padded_dim(d)
    if k.shape[1] != n or n % INT8_CHUNK or dp == 0:
        raise ValueError(f"flash_attention_int8: self-attention with N a multiple of "
                         f"{INT8_CHUNK} and a head dim the kernel takes, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    return dp


def int8_scratch_shapes(b: int, n: int, h: int, d: int, mode: str) -> dict:
    """The scratch K5 reads and writes besides q, k, v and the output: Q's
    and K's int8 codes ``[B, H, N, DP]`` and fp32 scales ``[B, H, N]``; in
    "qkpv" V's codes transposed, ``[B, H, DP, N]`` (each feature's keys
    contiguous, in P's fragment order within each 32), and V's fp32 scales
    per chunk ``[B, H, N / 1024, DP]``."""
    dp = int8_padded_dim(d)
    shapes = {"qq": (b, h, n, dp), "sq": (b, h, n), "kq": (b, h, n, dp), "sk": (b, h, n)}
    if mode == "qkpv":
        shapes.update(vq=(b, h, dp, n), sv=(b, h, n // INT8_CHUNK, dp))
    return shapes


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None, mode: str = "qk") -> torch.Tensor:
    """Self-attention over ``[B, N, H, D]`` with int8 QKᵀ ("qk") or int8 QKᵀ
    and P·V ("qkpv"); N a multiple of 1024. Returns ``[B, N, H, D]``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mode not in ("qk", "qkpv"):
        raise ValueError(f"flash_attention_int8: mode {mode!r}, expected qk or qkpv")
    check_no_grad("flash_attention_int8", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_int8_plain(q, k, v, scale, mode)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_int8: no path for device {q.device}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    dp = _check_int8_inputs(q, k, v)
    b, n, h, d = q.shape
    lib = kernels()
    if lib.sdt_flash_int8_padded_dim(d) != dp:
        raise RuntimeError(f"flash_attention_int8: the library pads d={d} to "
                           f"{lib.sdt_flash_int8_padded_dim(d)}, the wrapper to {dp}")
    dev = q.device
    out = torch.empty_like(q)
    pv8 = mode == "qkpv"
    t = {name: torch.empty(shape, dtype=torch.int8 if name in ("qq", "kq", "vq") else torch.float32,
                           device=dev)
         for name, shape in int8_scratch_shapes(b, n, h, d, mode).items()}
    ptr = lambda name: t[name].data_ptr() if name in t else None
    with torch.cuda.device(dev):
        err = lib.sdt_flash_attention_int8(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ptr("qq"), ptr("sq"),
            ptr("kq"), ptr("sk"), ptr("vq"), ptr("sv"), b, n, h, d, float(scale) * _LOG2E,
            int(pv8), stream_of(q))
    check(err, "flash_attention_int8")
    flash_attention_int8.launches += 1
    flash_attention_int8.pv_launches += pv8
    return out


# launches, and those of them in "qkpv"
flash_attention_int8.launches = 0
flash_attention_int8.pv_launches = 0
