"""The half-UNet classifier trunk, NCHW (port of
``sd_tpu/models/encoder_unet.py``; the reference's ``EncoderUNetModel``).

The UNet's input stack and middle block (the port's ``ResBlock``,
``Downsample`` and legacy ``QKVAttentionBlock``) and a pooling head
(``pool``): ``adaptive`` (GroupNorm, SiLU, a global average, a 1x1 conv),
``attention`` (GroupNorm, SiLU, :class:`AttentionPool2d`), ``spatial`` and
``spatial_v2`` (the spatial means of every block's output, concatenated,
through two linear layers, with ReLU or GroupNorm and SiLU between). The
noisy-latent classifier (``training/classifier.py``) trains it. Names
follow the reference's ``state_dict`` (``time_embed.{0,2}``,
``input_blocks.{i}.{j}``, ``middle_block.{j}``, ``out.{k}``), which
``utils/convert.py::encoder_unet_state_dict`` writes from ``sd_tpu``'s
parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence

import torch
from torch import nn

from sd_tpu_torch.core.schedules import timestep_embedding
from sd_tpu_torch.ops.attention import AttentionPool2d, QKVAttentionBlock
from sd_tpu_torch.ops.norms import GroupNorm32
from sd_tpu_torch.ops.resblock import Downsample, ResBlock

__all__ = ["EncoderUNetConfig", "EncoderUNetModel", "POOLS"]

POOLS = ("adaptive", "attention", "spatial", "spatial_v2")


@dataclasses.dataclass(frozen=True)
class EncoderUNetConfig:
    in_channels: int
    model_channels: int
    out_channels: int
    num_res_blocks: int
    attention_resolutions: Sequence[int]
    image_size: int = 64
    dropout: float = 0.0
    channel_mult: Sequence[int] = (1, 2, 4, 8)
    conv_resample: bool = True
    use_checkpoint: bool = False
    num_heads: int = 1
    num_head_channels: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_new_attention_order: bool = False
    pool: str = "adaptive"

    def __post_init__(self):
        if self.pool not in POOLS:
            raise ValueError(f"pool {self.pool!r}: one of {POOLS}")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EncoderUNetConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class EncoderUNetModel(nn.Module):
    """``forward(x [B, C, H, W], timesteps [B])`` → logits ``[B,
    out_channels]``, in the dtype of ``x``."""

    def __init__(self, config: EncoderUNetConfig):
        super().__init__()
        cfg = self.config = config
        emb_ch = 4 * cfg.model_channels
        self.time_embed = nn.Sequential(nn.Linear(cfg.model_channels, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))
        res = lambda ch, out_ch=None, down=False: ResBlock(
            ch, emb_ch, dropout=cfg.dropout, out_channels=out_ch,
            use_scale_shift_norm=cfg.use_scale_shift_norm, down=down)
        ch = cfg.model_channels
        blocks = [[nn.Conv2d(cfg.in_channels, ch, 3, padding=1)]]
        widths = [ch]  # each block's output channels (the spatial pools' features)
        ds = 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                block = [res(ch, mult * cfg.model_channels)]
                ch = mult * cfg.model_channels
                if ds in cfg.attention_resolutions:
                    block.append(self._attention(ch))
                blocks.append(block)
                widths.append(ch)
            if level != len(cfg.channel_mult) - 1:
                blocks.append([res(ch, down=True) if cfg.resblock_updown
                               else Downsample(ch, use_conv=cfg.conv_resample)])
                widths.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(nn.ModuleList(b) for b in blocks)
        self.middle_block = nn.ModuleList([res(ch), self._attention(ch), res(ch)])
        widths.append(ch)
        if cfg.pool == "adaptive":
            self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), nn.AdaptiveAvgPool2d(1),
                                     nn.Conv2d(ch, cfg.out_channels, 1), nn.Flatten())
        elif cfg.pool == "attention":
            self.out = nn.Sequential(GroupNorm32(ch), nn.SiLU(), AttentionPool2d(
                cfg.image_size // ds, ch, max(cfg.num_head_channels, 1), cfg.out_channels))
        elif cfg.pool == "spatial":
            self.out = nn.Sequential(nn.Linear(sum(widths), 2048), nn.ReLU(),
                                     nn.Linear(2048, cfg.out_channels))
        else:
            self.out = nn.Sequential(nn.Linear(sum(widths), 2048), GroupNorm32(2048), nn.SiLU(),
                                     nn.Linear(2048, cfg.out_channels))

    def _attention(self, ch: int) -> QKVAttentionBlock:
        cfg = self.config
        heads = cfg.num_heads if cfg.num_head_channels == -1 else ch // cfg.num_head_channels
        return QKVAttentionBlock(ch, heads, cfg.use_new_attention_order)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dtype = self.time_embed[0].weight.dtype
        emb = self.time_embed(timestep_embedding(timesteps, cfg.model_channels).to(dtype))
        spatial = cfg.pool.startswith("spatial")
        means = []
        h = x.to(dtype)
        for block in [*self.input_blocks, self.middle_block]:
            for layer in block:
                h = layer(h, emb) if isinstance(layer, ResBlock) else layer(h)
            if spatial:
                means.append(h.mean(dim=(2, 3)))
        if not spatial:
            return self.out(h).to(x.dtype)
        fc1, *rest = self.out
        feats = fc1(torch.cat(means, dim=-1))
        if cfg.pool == "spatial_v2":  # GroupNorm over the features as channels
            feats = rest.pop(0)(feats[:, :, None, None])[:, :, 0, 0]
        for layer in rest:
            feats = layer(feats)
        return feats.to(x.dtype)
