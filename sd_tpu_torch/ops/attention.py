"""Attention and the gated feed-forward (port of ``sd_tpu/ops/attention.py``).

Tensors are token-major ``[B, N, H, D]`` at :func:`dot_product_attention`, as
in ``sd_tpu``. :func:`attention_route` is the dispatch of an unmasked call,
a pure function of (device type, dtype, B, Nq, Nk, H, d). On a CUDA tensor:

- every unmasked self-attention call (``Nq == Nk``), at every head dim,
  goes to the K1 kernel (``ops/cuda/flash_attention.py``), including the
  UNet's 8x8 mid-block and cin256-v2's d = 960 sites at N = 64; where
  autograd records, its backward is K3 or the plain backward by
  ``sd_tpu``'s rule;
- cross-attention (77 keys) and CLIP's causal masked attention use plain
  torch ops with an fp32 softmax, as ``sd_tpu`` leaves them to XLA;
- every GEGLU feed-forward goes to the K2 kernel (``ops/cuda/geglu_ff.py``),
  whose backward recomputes through the plain version, unless the module
  trains with a dropout above 0: then GEGLU, the dropout and the output
  projection run in plain PyTorch, as ``sd_tpu`` takes its kernel only for a
  deterministic call or a dropout of 0.

The kernels are bf16. :func:`takes_kernel` is the dispatch rule on the
dtype: a CUDA tensor that is not bf16 (an fp32 model, ``SD_TPU_PRECISION=fp32``,
or training outside autocast) goes to the plain versions
(``flash_attention_plain``, ``geglu_ff_plain``), as ``sd_tpu``'s FF gate
sends non-bf16 inputs to XLA. The dtype is the one the kernel would see:
autocast's where autocast is on.

In the int8 serving mode (``ops/quant.py``; the mode is held on each
module's ``int8``), as ``sd_tpu``: the self-attention sites that
``resolve_int8`` accepts (full rows of 2048, 3072 or 4096 keys, at every
head dim) go to K5, the FF
sites that pass ``int8_ff_supported`` to K4, and with the ``proj`` bucket
the projections to K6: self-attention's Q, K and V in one call on the
concatenated ``[3C, C]`` weight, cross-attention's Q (K and V of the
77-token context stay bf16), and every ``to_out``. The int8 weights are
quantized at load time and held per module (``quant.Int8Weights``).

On a CPU tensor each kernel wrapper computes its plain version.

The OpenAI UNet's legacy pixel-space block (:class:`QKVAttentionBlock`)
and the classifier's pooling head (:class:`AttentionPool2d`) send their
self-attention through :func:`dot_product_attention` too, so K1 takes it on
the card; they have no int8 mode, as in ``sd_tpu``. The VAE's
:class:`LinearAttention` is plain PyTorch, as in ``sd_tpu``.

Modules keep the CompVis ``state_dict`` names (``to_q``, ``to_out.0``,
``ff.net.0.proj``, ``ff.net.2``, ``transformer_blocks.0``, ``qkv``,
``to_qkv`` ...). The 1x1 convs (``proj_in``/``proj_out``, the VAE
``q``/``k``/``v``, the legacy block's ``Conv1d`` ``qkv``/``proj_out``) keep
their weights and are applied as linear maps over tokens.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.ops import quant
from sd_tpu_torch.ops.cuda import (
    differentiable_flash_attention,
    differentiable_geglu_ff,
    flash_attention_int8,
    flash_attention_plain,
    geglu_ff_int8,
    int8_dense,
    resolve_int8,
)
from sd_tpu_torch.ops.cuda.geglu_ff import (geglu_ff_plain, int8_ff_supported, quantize_cols,
                                            quantize_ff_weights)
from sd_tpu_torch.ops.cuda.int8_dense import block_m, int8_width_ok
from sd_tpu_torch.ops.norms import GroupNorm32, LayerNormFp32

__all__ = [
    "takes_kernel",
    "attention_route",
    "dot_product_attention",
    "GEGLU",
    "FeedForward",
    "CrossAttention",
    "BasicTransformerBlock",
    "SpatialTransformer",
    "VAEAttnBlock",
    "QKVAttentionBlock",
    "AttentionPool2d",
    "LinearAttention",
]


def takes_kernel(device_type: str, dtype: torch.dtype) -> bool:
    """Whether a call goes to a kernel wrapper: always on the CPU (where the
    wrappers compute their plain versions), and on the card only in bf16,
    the kernels' dtype; another dtype on the card takes the plain version."""
    return device_type != "cuda" or dtype == torch.bfloat16


def _kernel_dtype(t: torch.Tensor) -> torch.dtype:
    """The dtype a kernel wrapper would be handed: autocast's where autocast
    is on for the tensor's device (the wrappers cast to it), else the tensor's."""
    if torch.is_autocast_enabled(t.device.type):
        return torch.get_autocast_dtype(t.device.type)
    return t.dtype


def _takes_kernel(t: torch.Tensor) -> bool:
    return takes_kernel(t.device.type, _kernel_dtype(t))


def attention_route(device_type: str, dtype: torch.dtype, b: int, nq: int, nk: int, h: int,
                    d: int) -> str:
    """Where an unmasked attention call of ``[B, Nq, H, d]`` queries over Nk
    keys goes: "K1" (the kernel wrapper, which computes the plain version on
    the CPU) or "plain". Cross-attention and the card's other dtypes are
    "plain"; self-attention is "K1" at every B, N, H and head dim."""
    if nq != nk or not takes_kernel(device_type, dtype):
        return "plain"
    return "K1"


def dot_product_attention(q, k, v, scale: Optional[float] = None,
                          mask: Optional[torch.Tensor] = None,
                          int8: quant.Int8Mode = quant.INT8_OFF) -> torch.Tensor:
    """Multi-head scaled dot-product attention over ``[B, N, H, D]``;
    ``int8`` is the serving mode of the calling module."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, nq, h, d = q.shape
    if mask is None and attention_route(q.device.type, _kernel_dtype(q), b, nq, k.shape[1], h,
                                        d) == "K1":
        mode = resolve_int8(int8, q, k)
        if mode != "off":
            return flash_attention_int8(q, k, v, scale, mode)
        return differentiable_flash_attention(q, k, v, scale)
    return flash_attention_plain(q, k, v, scale, mask)


def _linear_1x1(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """Apply a 1x1 ``Conv2d`` (or width-1 ``Conv1d``) to tokens ``[..., C]``."""
    return F.linear(x, conv.weight.flatten(1), conv.bias)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(b, h * w, c)


def _from_tokens(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    b, _, c = x.shape
    return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


class GEGLU(nn.Module):
    """The gated projection; holds ``proj`` (``[2·dim_out, dim_in]``, value
    rows first). :class:`FeedForward` applies it through the K2 kernel, or
    through this module's own forward where it keeps the dropout."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(quant.Int8Weights, nn.Module):
    """Gated transformer MLP ``net = [GEGLU, Dropout, Linear]``, applied as one
    K2 call (:func:`differentiable_geglu_ff`), or one K4 call where the int8
    mode's site gate passes; module by module where it trains with a dropout
    above 0, and through the plain version where the card's input is not bf16."""

    int8_bucket = "ff"

    def __init__(self, dim: int, dim_out: Optional[int] = None, mult: int = 4,
                 dropout: float = 0.0):
        super().__init__()
        inner = int(dim * mult)
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Dropout(dropout),
                                 nn.Linear(inner, dim_out or dim))

    def int8_sources(self):
        return self.net[0].proj.weight, self.net[2].weight

    def int8_quantize(self):
        w1, w2 = self.int8_sources()
        return quantize_ff_weights(w1, w2, w1.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        geglu, dropout, out = self.net
        if self.training and dropout.p > 0:
            return out(dropout(geglu(x)))
        proj = geglu.proj
        # a row-parallel output projection (parallel/tp.py) sums the ranks'
        # partial outputs and adds its bias after the sum
        reduce = getattr(out, "reduce", None)
        b2 = out.bias if reduce is None else torch.zeros_like(out.bias)
        if not _takes_kernel(x):
            y = geglu_ff_plain(x, proj.weight, proj.bias, out.weight, b2)
        elif int8_ff_supported(self.int8, x, out.weight.shape[1]):
            y = geglu_ff_int8(x, proj.weight, proj.bias, out.weight, b2, self.int8_weights())
        else:
            y = differentiable_geglu_ff(x, proj.weight, proj.bias, out.weight, b2)
        return y if reduce is None else reduce(y)


class CrossAttention(quant.Int8Weights, nn.Module):
    """Self (``context=None``) or cross attention over ``[B, N, C]`` tokens."""

    int8_bucket = "proj"

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

    def int8_sources(self):
        return self.to_q.weight, self.to_k.weight, self.to_v.weight, self.to_out[0].weight

    def int8_quantize(self):
        """The ``proj`` bucket's int8 weights: Q (with K and V behind it
        where they share Q's input width, for the fused self-attention
        call) and ``to_out``, per output channel. The rows of the
        concatenation are quantized each on its own, so its first third is
        Q's quantization."""
        w = self.to_q.weight
        if self.to_k.weight.shape == w.shape:
            w = torch.cat([w, self.to_k.weight, self.to_v.weight])
        qkv_q, qkv_s = quantize_cols(w)
        out_q, out_s = quantize_cols(self.to_out[0].weight)
        return dict(qkv_q=qkv_q, qkv_s=qkv_s, out_q=out_q, out_s=out_s)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        is_self = context is None
        context = x if context is None else context
        b, nq, _ = x.shape
        nk = context.shape[1]
        h, d = self.heads, self.dim_head
        # sd_tpu's int8_dense takes the plain product where no row block fits;
        # so do widths K6 does not take (the input's and to_out's)
        proj = (quant.int8_bucket_enabled(self.int8, "proj", x)
                and block_m(b * nq) is not None
                and int8_width_ok(x.shape[-1]) and int8_width_ok(h * d))
        qw = self.int8_weights() if proj else None
        if proj and is_self:
            q, k, v = int8_dense(x, None, prequant=(qw["qkv_q"], qw["qkv_s"])).chunk(3, dim=-1)
        else:
            if proj:
                inner = h * d
                q = int8_dense(x, self.to_q.weight,
                               prequant=(qw["qkv_q"][:inner], qw["qkv_s"][:inner]))
            else:
                q = self.to_q(x)
            k, v = self.to_k(context), self.to_v(context)
        q = q.reshape(b, nq, h, d)
        k = k.reshape(b, nk, h, d)
        v = v.reshape(b, nk, h, d)
        out = dot_product_attention(q, k, v, scale=d**-0.5, int8=self.int8)
        out = out.reshape(b, nq, h * d)
        if proj:
            lin = self.to_out[0]
            out = int8_dense(out, lin.weight, lin.bias, prequant=(qw["out_q"], qw["out_s"]))
            return self.to_out[1](out)
        return self.to_out(out)


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

    int8 = quant.INT8_OFF

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
        out = dot_product_attention(q, k, v, scale=c**-0.5, int8=self.int8)
        out = _linear_1x1(out.reshape(b, hh * ww, c), self.proj_out)
        return x + _from_tokens(out, hh, ww)


class QKVAttentionBlock(nn.Module):
    """The OpenAI UNet's legacy self-attention block over ``[B, C, H, W]``:
    GroupNorm, a fused 1x1 ``qkv`` (``Conv1d``, weight ``[3C, C, 1]``),
    attention over the H·W tokens in ``num_heads`` heads of C / heads, a 1x1
    ``proj_out`` and the residual. The fused projection's channels are laid
    out ``[heads, 3, d]`` (``QKVAttentionLegacy``) or, with
    ``use_new_attention_order``, ``[3, heads, d]`` (``QKVAttention``)."""

    def __init__(self, channels: int, num_heads: int, use_new_attention_order: bool = False):
        super().__init__()
        if channels % num_heads:
            raise ValueError(f"{channels} channels do not split into {num_heads} heads")
        self.num_heads = num_heads
        self.use_new_attention_order = use_new_attention_order
        self.norm = GroupNorm32(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        n, heads = hh * ww, self.num_heads
        d = c // heads
        qkv = _linear_1x1(_to_tokens(self.norm(x)), self.qkv)
        if self.use_new_attention_order:
            q, k, v = qkv.view(b, n, 3, heads, d).unbind(2)
        else:
            q, k, v = qkv.view(b, n, heads, 3, d).unbind(3)
        out = dot_product_attention(q, k, v, scale=d**-0.5)
        out = _linear_1x1(out.reshape(b, n, c), self.proj_out)
        return x + _from_tokens(out, hh, ww)


class AttentionPool2d(nn.Module):
    """CLIP's attention pooling head of the classifier's trunk, over ``[B, C,
    H, W]``: the tokens' mean is prepended as a class token, a learned
    ``positional_embedding`` (``[C, H·W + 1]``, the reference's layout) is
    added, one attention layer runs in heads of ``num_heads_channels``
    (``qkv_proj``, a width-1 ``Conv1d`` laid out ``[3, heads, d]``, then
    ``c_proj``), and the class token's output, ``[B, output_dim]``, is
    returned. Its attention goes through :func:`dot_product_attention`, so
    :func:`attention_route` decides the route at N = H·W + 1."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads_channels: int,
                 output_dim: Optional[int] = None):
        super().__init__()
        if embed_dim % num_heads_channels:
            raise ValueError(f"{embed_dim} channels do not split into heads of "
                             f"{num_heads_channels}")
        self.positional_embedding = nn.Parameter(
            torch.randn(embed_dim, spacial_dim ** 2 + 1) / embed_dim ** 0.5)
        self.qkv_proj = nn.Conv1d(embed_dim, 3 * embed_dim, 1)
        self.c_proj = nn.Conv1d(embed_dim, output_dim or embed_dim, 1)
        self.num_heads = embed_dim // num_heads_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        n, heads = hh * ww + 1, self.num_heads
        d = c // heads
        t = _to_tokens(x)
        t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)
        t = t + self.positional_embedding.t()[None].to(t.dtype)
        q, k, v = _linear_1x1(t, self.qkv_proj).view(b, n, 3, heads, d).unbind(2)
        out = dot_product_attention(q, k, v, scale=d**-0.5)
        return _linear_1x1(out.reshape(b, n, c), self.c_proj)[:, 0]


class LinearAttention(nn.Module):
    """O(N) attention over ``[B, C, H, W]`` (the VAE's ``attn_type:
    linear``): a bias-free 1x1 ``to_qkv`` laid out ``[3, heads, d]``, k
    softmaxed over the tokens in fp32, the context kᵀv once per head, then
    a 1x1 ``to_out``; no norm and no residual, as in the reference."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, 3 * hidden, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, hh, ww = x.shape
        qkv = self.to_qkv(x).reshape(b, 3, self.heads, self.dim_head, hh * ww)
        q, k, v = qkv.unbind(1)                                  # [B, heads, d, N]
        k = torch.softmax(k.float(), dim=-1).to(x.dtype)
        context = torch.einsum("bhdn,bhen->bhde", k, v)
        out = torch.einsum("bhde,bhdn->bhen", context, q)
        return self.to_out(out.reshape(b, self.heads * self.dim_head, hh, ww))
