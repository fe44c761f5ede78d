"""Conditioning encoders (port of ``ClassEmbedder``, ``TransformerEmbedder``,
``BERTEmbedder``, ``SpatialRescaler`` and ``HybridConditioner`` from
``sd_tpu/models/encoders.py``).

- :class:`ClassEmbedder`: class ids ``[B]`` → one crossattn token
  ``[B, 1, embed_dim]``;
- :class:`TransformerEmbedder` and :class:`BERTEmbedder`: token ids
  ``[B, N]`` → ``[B, N, n_embed]`` through the x-transformers encoder the
  reference vendors (token and learned position embeddings, pre-LN
  attention and GELU feed-forward pairs with 64-wide heads, a final
  LayerNorm). BERTEmbedder is the 32-layer, 1280-wide one of the LAION
  txt2img model; its ids come from the caller (the BERT vocabulary is not
  in the repository).

State-dict names are the reference's (``embedding.weight``;
``transformer.token_emb.weight``, ``transformer.pos_emb.emb.weight``,
``transformer.attn_layers.layers.{2l}.0`` and ``.1.to_q`` ..., ``{2l+1}.1.net.0.0``,
``transformer.norm``), which ``sd_tpu``'s ``port_transformer_wrapper`` reads.
Attention goes through ``ops/attention.dot_product_attention``: K1 on the
card (N = 77, d = 64), and K1 with its backward where the encoder trains.

- :class:`SpatialRescaler`: ``n_stages`` resizes of an NCHW map by
  ``multiplier`` (sizes ``max(int(h · multiplier), 1)``), as
  ``jax.image.resize`` computes them (``ops/resize.py``, antialiased where
  it shrinks), then an optional bias-free 1x1 ``channel_mapper``. As in
  ``sd_tpu``, ``area`` resizes as ``linear`` (the reference's ``area`` is
  an average over cells), and every linear method is the triangle kernel;
- :class:`HybridConditioner`: a concat and a crossattn conditioner, whose
  outputs form the cond dict of the ``hybrid`` conditioning key.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from sd_tpu_torch.ops.attention import dot_product_attention
from sd_tpu_torch.ops.norms import LayerNormFp32
from sd_tpu_torch.ops.resize import resize

__all__ = ["ClassEmbedder", "TransformerWrapper", "TransformerEmbedder", "BERTEmbedder",
           "SpatialRescaler", "HybridConditioner", "RESCALER_METHODS"]

# x-transformers' DEFAULT_DIM_HEAD: the head width, not n_embed // heads
DIM_HEAD = 64


class ClassEmbedder(nn.Module):
    def __init__(self, embed_dim: int, n_classes: int = 1000):
        super().__init__()
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, c: torch.Tensor) -> torch.Tensor:
        return self.embedding(c.reshape(-1).long())[:, None, :]

    encode = forward


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        inner = heads * DIM_HEAD
        self.heads = heads
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (f(x).reshape(b, n, self.heads, DIM_HEAD)
                   for f in (self.to_q, self.to_k, self.to_v))
        out = dot_product_attention(q, k, v, scale=DIM_HEAD ** -0.5)
        return self.to_out(out.reshape(b, n, self.heads * DIM_HEAD))


class _FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(nn.Sequential(nn.Linear(dim, dim * mult), nn.GELU()),
                                 nn.Dropout(0.0), nn.Linear(dim * mult, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class _Layers(nn.Module):
    """``layers[2l]`` = [LayerNorm, attention], ``layers[2l + 1]`` =
    [LayerNorm, feed-forward], each added to its input."""

    def __init__(self, dim: int, depth: int, heads: int):
        super().__init__()
        self.layers = nn.ModuleList()
        for _ in range(depth):
            self.layers.append(nn.ModuleList([LayerNormFp32(dim), _Attention(dim, heads)]))
            self.layers.append(nn.ModuleList([LayerNormFp32(dim), _FeedForward(dim)]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for norm, block in self.layers:
            x = x + block(norm(x))
        return x


class _PositionEmbedding(nn.Module):
    def __init__(self, dim: int, max_seq_len: int):
        super().__init__()
        self.emb = nn.Embedding(max_seq_len, dim)


class TransformerWrapper(nn.Module):
    """Token ids ``[B, N]`` → embeddings ``[B, N, n_embed]``."""

    def __init__(self, n_embed: int, n_layer: int, vocab_size: int, max_seq_len: int = 77,
                 heads: int = 8):
        super().__init__()
        self.token_emb = nn.Embedding(vocab_size, n_embed)
        self.pos_emb = _PositionEmbedding(n_embed, max_seq_len)
        self.attn_layers = _Layers(n_embed, n_layer, heads)
        self.norm = LayerNormFp32(n_embed)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        n = tokens.shape[1]
        x = self.token_emb(tokens.long()) + self.pos_emb.emb.weight[None, :n]
        return self.norm(self.attn_layers(x))


class TransformerEmbedder(nn.Module):
    """The x-transformers encoder as the reference's ``TransformerEmbedder``
    holds it (``transformer``)."""

    def __init__(self, n_embed: int, n_layer: int, vocab_size: int = 30522,
                 max_seq_len: int = 77, heads: int = 8):
        super().__init__()
        self.transformer = TransformerWrapper(n_embed, n_layer, vocab_size, max_seq_len, heads)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer(tokens)

    encode = forward


class BERTEmbedder(TransformerEmbedder):
    """The LAION txt2img model's text encoder: 32 layers of 1280 by default."""

    def __init__(self, n_embed: int = 1280, n_layer: int = 32, vocab_size: int = 30522,
                 max_seq_len: int = 77):
        super().__init__(n_embed, n_layer, vocab_size, max_seq_len)


# the reference's methods, each → the jax.image.resize method sd_tpu gives it
RESCALER_METHODS = {"nearest": "nearest", "linear": "bilinear", "bilinear": "bilinear",
                    "trilinear": "trilinear", "bicubic": "bicubic", "area": "linear"}


class SpatialRescaler(nn.Module):
    """``n_stages`` resizes by ``multiplier``, then an optional 1x1 conv to
    ``out_channels`` (``channel_mapper``), on ``[B, C, H, W]``."""

    def __init__(self, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                 in_channels: int = 3, out_channels: Optional[int] = None, bias: bool = False):
        super().__init__()
        if n_stages < 0 or method not in RESCALER_METHODS:
            raise ValueError(f"SpatialRescaler: n_stages {n_stages}, method {method!r} (one of "
                             f"{sorted(RESCALER_METHODS)})")
        self.n_stages, self.method, self.multiplier = n_stages, method, multiplier
        self.channel_mapper = (None if out_channels is None
                               else nn.Conv2d(in_channels, out_channels, 1, bias=bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for _ in range(self.n_stages):
            h, w = x.shape[-2:]
            x = resize(x, (max(int(h * self.multiplier), 1), max(int(w * self.multiplier), 1)),
                       RESCALER_METHODS[self.method])
        if self.channel_mapper is not None:
            x = self.channel_mapper(x)
        return x

    encode = forward


class HybridConditioner(nn.Module):
    """A concat conditioner and a crossattn conditioner; returns the cond
    dict of the ``hybrid`` key, ``{"c_concat": [...], "c_crossattn": [...]}``."""

    def __init__(self, concat_conditioner: nn.Module, crossattn_conditioner: nn.Module):
        super().__init__()
        self.concat_conditioner = concat_conditioner
        self.crossattn_conditioner = crossattn_conditioner

    def forward(self, c_concat: torch.Tensor, c_crossattn: torch.Tensor
                ) -> Dict[str, List[torch.Tensor]]:
        return {"c_concat": [self.concat_conditioner(c_concat)],
                "c_crossattn": [self.crossattn_conditioner(c_crossattn)]}
