"""CLIP text tower (port of ``sd_tpu/models/clip.py``).

Token + position embeddings, pre-LN blocks with causal self-attention and a
quick-GELU MLP, final LayerNorm; ``pooler_output`` is the hidden state at
the EOT position (the argmax token id). Parameter names follow the HF
``CLIPTextModel`` (``text_model.embeddings.token_embedding``,
``text_model.encoder.layers.{i}.self_attn.q_proj`` ...), which is what
``sd_tpu.models.clip.port_clip_text`` reads.

:class:`CLIPTextModelWithProjection` is the ``FrozenCLIPTextEmbedder``
contract, the RDM's retrieval query: the pooled output through HF's
bias-free ``text_projection``, L2-normalized with ``normalize``. The
tower's attention is causal and masked, so it takes the plain route on the
card (no kernel site).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from sd_tpu_torch.ops.attention import dot_product_attention
from sd_tpu_torch.ops.norms import LayerNormFp32

__all__ = ["CLIPTextConfig", "CLIPTextModel", "CLIPTextModelWithProjection",
           "CLIP_VIT_L_14_TEXT"]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    projection_dim: int = 768
    eos_token_id: int = 49407


# openai/clip-vit-large-patch14 text tower
CLIP_VIT_L_14_TEXT = CLIPTextConfig()


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        q = self.q_proj(x).view(b, n, self.heads, d)
        k = self.k_proj(x).view(b, n, self.heads, d)
        v = self.v_proj(x).view(b, n, self.heads, d)
        out = dot_product_attention(q, k, v, scale=d**-0.5, mask=mask)
        return self.out_proj(out.reshape(b, n, c))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        return self.fc2(x * torch.sigmoid(1.702 * x))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm1 = LayerNormFp32(cfg.hidden_size)
        self.mlp = CLIPMLP(cfg)
        self.layer_norm2 = LayerNormFp32(cfg.hidden_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = nn.Module()
        self.embeddings.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.embeddings.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                                          cfg.hidden_size)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(CLIPEncoderLayer(cfg)
                                            for _ in range(cfg.num_hidden_layers))
        self.final_layer_norm = LayerNormFp32(cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        b, n = input_ids.shape
        emb = self.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[None, :n]
        causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()[None, None]
        for layer in self.encoder.layers:
            x = layer(x, causal)
        x = self.final_layer_norm(x)
        pooled = x[torch.arange(b, device=x.device), input_ids.argmax(dim=-1)]
        return {"last_hidden_state": x, "pooler_output": pooled}


class CLIPTextModel(nn.Module):
    """``forward(input_ids [B, N])`` → ``{"last_hidden_state", "pooler_output"}``."""

    def __init__(self, cfg: CLIPTextConfig = CLIP_VIT_L_14_TEXT):
        super().__init__()
        self.text_model = CLIPTextTransformer(cfg)

    def forward(self, input_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.text_model(input_ids)

    def encode(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The non-pooled context ``[B, N, hidden]`` (FrozenCLIPEmbedder's)."""
        return self(input_ids)["last_hidden_state"]


class CLIPTextModelWithProjection(nn.Module):
    """``forward(input_ids [B, N])`` → ``[B, projection_dim]``: the EOT-pooled
    output through ``text_projection`` (``[projection_dim, hidden]``, no
    bias, HF's ``text_projection.weight``), divided by its L2 norm when
    ``normalize`` (``sd_tpu``'s ``CLIPTextModelWithProjection``)."""

    def __init__(self, cfg: CLIPTextConfig = CLIP_VIT_L_14_TEXT, normalize: bool = True):
        super().__init__()
        self.normalize = normalize
        self.text_model = CLIPTextTransformer(cfg)
        self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        pooled = self.text_model(input_ids)["pooler_output"]
        z = self.text_projection(pooled)
        if self.normalize:
            z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        return z
