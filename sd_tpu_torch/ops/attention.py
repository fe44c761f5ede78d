"""Attention and the gated feed-forward (port of ``sd_tpu/ops/attention.py``).

Tensors are token-major ``[B, N, H, D]`` at :func:`dot_product_attention`, as
in ``sd_tpu``. Dispatch on a CUDA tensor:

- every unmasked self-attention call (``Nq == Nk``) goes to the K1 kernel
  (``ops/cuda/flash_attention.py``), including the UNet's 8x8 mid-block;
  where autograd records, its backward is K3 or the plain backward by
  ``sd_tpu``'s rule;
- cross-attention (77 keys) and CLIP's causal masked attention use plain
  torch ops with an fp32 softmax, as ``sd_tpu`` leaves them to XLA;
- every GEGLU feed-forward goes to the K2 kernel (``ops/cuda/geglu_ff.py``),
  whose backward recomputes through the plain version.

On a CPU tensor each kernel wrapper computes its plain version.

Modules keep the CompVis ``state_dict`` names (``to_q``, ``to_out.0``,
``ff.net.0.proj``, ``ff.net.2``, ``transformer_blocks.0`` ...). The 1x1
convs (``proj_in``/``proj_out``, the VAE ``q``/``k``/``v``) keep their
``Conv2d`` weights and are applied as linear maps over tokens.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.ops.cuda import (
    differentiable_flash_attention,
    differentiable_geglu_ff,
    flash_attention_plain,
)
from sd_tpu_torch.ops.norms import GroupNorm32, LayerNormFp32

__all__ = [
    "dot_product_attention",
    "GEGLU",
    "FeedForward",
    "CrossAttention",
    "BasicTransformerBlock",
    "SpatialTransformer",
    "VAEAttnBlock",
]


def dot_product_attention(q, k, v, scale: Optional[float] = None,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head scaled dot-product attention over ``[B, N, H, D]``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if mask is None and q.shape[1] == k.shape[1]:
        return differentiable_flash_attention(q, k, v, scale)
    return flash_attention_plain(q, k, v, scale, mask)


def _linear_1x1(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Apply a 1x1 ``Conv2d`` to tokens ``[..., C]``."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _from_tokens(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c = x.shape
    return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


class GEGLU(nn.Module):
    """The gated projection; holds ``proj`` (``[2·dim_out, dim_in]``, value
    rows first). :class:`FeedForward` applies it through the K2 kernel."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)


class FeedForward(nn.Module):
    """Gated transformer MLP ``net = [GEGLU, Dropout, Linear]``, applied as one
    K2 call (:func:`differentiable_geglu_ff`)."""

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4,
                 dropout: float = 0.0):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Dropout(dropout),
                                 nn.Linear(inner, dim_out or dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj, out = self.net[0].proj, self.net[2]
        return differentiable_geglu_ff(x, proj.weight, proj.bias, out.weight, out.bias)


class CrossAttention(nn.Module):
    """Self (``context=None``) or cross attention over ``[B, N, C]`` tokens."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dim_head: int = 64, dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        context = x if context is None else context
        b, nq, _ = x.shape
        nk = context.shape[1]
        h, d = self.heads, self.dim_head
        q = self.to_q(x).view(b, nq, h, d)
        k = self.to_k(context).view(b, nk, h, d)
        v = self.to_v(context).view(b, nk, h, d)
        out = dot_product_attention(q, k, v, scale=d**-0.5)
        return self.to_out(out.reshape(b, nq, h * d))


class BasicTransformerBlock(nn.Module):
    """Pre-LN self-attention → cross-attention(context) → gated FF."""

    def __init__(self, dim: int, n_heads: int, d_head: int, dropout: float = 0.0,
                 context_dim: Optional[int] = None):
        super().__init__()
        self.attn1 = CrossAttention(dim, heads=n_heads, dim_head=d_head, dropout=dropout)
        self.ff = FeedForward(dim, dropout=dropout)
        self.attn2 = CrossAttention(dim, context_dim=context_dim, heads=n_heads,
                                    dim_head=d_head, dropout=dropout)
        self.norm1 = LayerNormFp32(dim)
        self.norm2 = LayerNormFp32(dim)
        self.norm3 = LayerNormFp32(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """GroupNorm → 1x1 proj_in → depth x BasicTransformerBlock over (h w)
    tokens → 1x1 proj_out → residual, on ``[B, C, H, W]``."""

    def __init__(self, in_channels: int, n_heads: int, d_head: int, depth: int = 1,
                 dropout: float = 0.0, context_dim: Optional[int] = None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNorm32(in_channels, eps=1e-6)
        self.proj_in = nn.Conv2d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head, dropout=dropout,
                                  context_dim=context_dim)
            for _ in range(depth))
        self.proj_out = nn.Conv2d(inner, in_channels, 1)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        hh, ww = x.shape[2:]
        h = _linear_1x1(_to_tokens(self.norm(x)), self.proj_in)
        for block in self.transformer_blocks:
            h = block(h, context=context)
        h = _linear_1x1(h, self.proj_out)
        return _from_tokens(h, hh, ww) + x


class VAEAttnBlock(nn.Module):
    """Single-head attention of the VAE mid-block (head dim = C, scale C^-0.5)."""

    def __init__(self, in_channels: int):
        super().__init__()
        c = in_channels
        self.norm = GroupNorm32(c, eps=1e-6)
        self.q = nn.Conv2d(c, c, 1)
        self.k = nn.Conv2d(c, c, 1)
        self.v = nn.Conv2d(c, c, 1)
        self.proj_out = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        t = _to_tokens(self.norm(x))
        q = _linear_1x1(t, self.q).view(b, hh * ww, 1, c)
        k = _linear_1x1(t, self.k).view(b, hh * ww, 1, c)
        v = _linear_1x1(t, self.v).view(b, hh * ww, 1, c)
        out = dot_product_attention(q, k, v, scale=c**-0.5)
        out = _linear_1x1(out.reshape(b, hh * ww, c), self.proj_out)
        return x + _from_tokens(out, hh, ww)
