"""K1: flash attention on ``[B, N, H, D]`` tensors.

Replaces the TPU kernel of ``sd_tpu/ops/pallas/flash_attention.py``
(``_kernel_chunked``/``_kernel``/``_kernel_allheads`` through ``_fwd_bhnd``,
entry ``flash_attention``). The CUDA kernel is
``sd_tpu_torch/csrc/flash_attention.cu``; its header says what bounds it on
the H100 and what its design does about that.

``flash_attention`` launches the kernel for a CUDA tensor and uses
:func:`flash_attention_plain` for a CPU tensor only. The card's path is bf16:
a CUDA tensor of another dtype raises, as does any shape the kernel does not
take. ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from sd_tpu_torch.ops.cuda._build import check, kernels, stream_of

__all__ = ["flash_attention", "flash_attention_plain"]

_MAX_HEAD_DIM = 512


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
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


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
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_inputs(q, k, v)
    b, nq, h, d = q.shape
    out = torch.empty_like(q)
    lib = kernels()
    with torch.cuda.device(q.device):
        err = lib.sdt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, nq, k.shape[1], h, d, float(scale), stream_of(q))
    check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
