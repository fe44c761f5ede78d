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
  does not take. ``flash_attention.launches`` and
  ``flash_attention_bwd.launches`` count kernel launches (one per call).
- :func:`differentiable_flash_attention` is the entry point for code that
  may need gradients: where autograd records, it runs a
  ``torch.autograd.Function`` whose forward is K1 (with the row log-sum-exp
  saved) and whose backward follows ``sd_tpu``'s ``_flash_bhnd_bwd``: K3 when
  Nk > 256 and Nq is a multiple of 256, the plain backward otherwise.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from sd_tpu_torch.ops.cuda._build import check, kernels, stream_of

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_lse_plain",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "differentiable_flash_attention"]

_MAX_HEAD_DIM = 512
_MAX_BWD_HEAD_DIM = 128
# sd_tpu's backward dispatch (_flash_bhnd_bwd): the kernel above 256 keys,
# when the queries tile by 256; the plain backward otherwise
_SMALL_KV = 256
_BLOCK_Q_BWD = 256


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
    if d % 8 or d > _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple of 8 "
                         f"and at most {_MAX_HEAD_DIM}")
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
    if d > _MAX_BWD_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: head dim {d} above {_MAX_BWD_HEAD_DIM}")


def _launch_forward(q, k, v, scale: float, with_lse: bool):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_inputs(q, k, v)
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


def uses_bwd_kernel(nq: int, nk: int) -> bool:
    """``sd_tpu``'s ``_flash_bhnd_bwd`` rule: the backward kernel where
    Nk > 256 and Nq % 256 == 0, the plain backward otherwise."""
    return nk > _SMALL_KV and nq % _BLOCK_Q_BWD == 0


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
        if uses_bwd_kernel(q.shape[1], k.shape[1]):
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
