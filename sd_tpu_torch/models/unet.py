"""The diffusion UNet, NCHW (port of ``sd_tpu/models/unet.py``).

One block plan (:func:`build_unet_plan`, the same walk as ``sd_tpu``'s, with
the reference's head-dim quirks) lays out the layers, so the port's
``state_dict`` names (``input_blocks.{i}.{j}``, ``middle_block.{j}``,
``output_blocks.{i}.{j}``, ``time_embed.{0,2}``, ``label_emb``, ``out.{0,2}``,
``id_predictor.{0,1}``) are the ones ``sd_tpu.models.unet.port_unet`` reads.
Attention is the crossattn ``SpatialTransformer`` or, without
``use_spatial_transformer``, the legacy pixel-space ``QKVAttentionBlock``
(its heads at the output sites from ``num_heads_upsample``, as
``sd_tpu``'s ``_head_config`` gives them). ``resblock_updown`` resamples
inside ResBlocks, ``conv_resample=False`` resamples without a conv,
``num_classes`` adds a class embedding (``y`` in ``forward``) to the
timestep's, and ``n_embed`` makes ``forward`` return the codebook head's
logits (``id_predictor``) instead of ``out``, which the module keeps, as
the reference does. With ``use_checkpoint`` (SD v1 sets it), each ResBlock
and attention application of a module in training mode is recomputed in the
backward pass (``torch.utils.checkpoint``), as ``sd_tpu`` wraps them in
``nn.remat``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from sd_tpu_torch.core.schedules import timestep_embedding
from sd_tpu_torch.ops.attention import QKVAttentionBlock, SpatialTransformer
from sd_tpu_torch.ops.norms import GroupNorm32
from sd_tpu_torch.ops.resblock import Downsample, ResBlock, Upsample

__all__ = ["UNetConfig", "UNetModel", "build_unet_plan"]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """The constructor knobs of the shipped YAML configs."""

    in_channels: int
    model_channels: int
    out_channels: int
    num_res_blocks: int
    attention_resolutions: Sequence[int]
    image_size: int = 32  # kept for config compat; not used in compute
    dropout: float = 0.0
    channel_mult: Sequence[int] = (1, 2, 4, 8)
    conv_resample: bool = True
    num_classes: Optional[int] = None
    use_checkpoint: bool = False
    num_heads: int = -1
    num_head_channels: int = -1
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = False
    resblock_updown: bool = False
    use_new_attention_order: bool = False
    use_spatial_transformer: bool = False
    transformer_depth: int = 1
    context_dim: Optional[int] = None
    n_embed: Optional[int] = None
    legacy: bool = True

    def __post_init__(self):
        if self.num_heads == -1 and self.num_head_channels == -1:
            raise ValueError("either num_heads or num_head_channels must be set")
        if self.use_spatial_transformer != (self.context_dim is not None):
            raise ValueError("use_spatial_transformer and context_dim go together")

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "UNetConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def _head_config(cfg: UNetConfig, ch: int, upsample_site: bool) -> Tuple[int, int]:
    """Per-site (num_heads, dim_head) as ``sd_tpu``'s ``_head_config`` gives
    them, the ``legacy`` quirk and the output sites' ``num_heads_upsample``
    included; ``dim_head`` may be -1 at a legacy block."""
    if cfg.num_head_channels == -1:
        heads, dim_head = cfg.num_heads, ch // cfg.num_heads
    else:
        heads, dim_head = ch // cfg.num_head_channels, cfg.num_head_channels
    if cfg.legacy:
        dim_head = ch // heads if cfg.use_spatial_transformer else cfg.num_head_channels
    if upsample_site and not cfg.use_spatial_transformer and cfg.num_head_channels == -1:
        heads = cfg.num_heads_upsample if cfg.num_heads_upsample != -1 else cfg.num_heads
    return heads, dim_head


def _attn_layer(cfg: UNetConfig, ch: int, upsample_site: bool = False) -> Dict[str, Any]:
    heads, dim_head = _head_config(cfg, ch, upsample_site)
    if cfg.use_spatial_transformer:
        return dict(kind="spatial_transformer", ch=ch, heads=heads, dim_head=dim_head,
                    depth=cfg.transformer_depth, context_dim=cfg.context_dim)
    # the legacy block's own head count: `heads` where its head width is -1,
    # else as many heads of that width as fit
    return dict(kind="attention", ch=ch, heads=heads if dim_head == -1 else ch // dim_head,
                use_new_attention_order=cfg.use_new_attention_order)


def build_unet_plan(cfg: UNetConfig) -> Dict[str, Any]:
    """Walk the constructor as the reference does, emitting layer descriptors."""
    input_blocks: List[List[Dict]] = [[dict(kind="conv_in", ch=cfg.model_channels)]]
    input_chans = [cfg.model_channels]
    ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [dict(kind="res", ch=ch, out_ch=mult * cfg.model_channels)]
            ch = mult * cfg.model_channels
            if ds in cfg.attention_resolutions:
                layers.append(_attn_layer(cfg, ch))
            input_blocks.append(layers)
            input_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append([dict(kind="res", ch=ch, out_ch=ch, down=True)
                                 if cfg.resblock_updown else dict(kind="downsample", ch=ch)])
            input_chans.append(ch)
            ds *= 2

    middle = [dict(kind="res", ch=ch, out_ch=ch), _attn_layer(cfg, ch),
              dict(kind="res", ch=ch, out_ch=ch)]

    output_blocks: List[List[Dict]] = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = input_chans.pop()
            layers = [dict(kind="res", ch=ch + ich, out_ch=cfg.model_channels * mult)]
            ch = cfg.model_channels * mult
            if ds in cfg.attention_resolutions:
                layers.append(_attn_layer(cfg, ch, upsample_site=True))
            if level and i == cfg.num_res_blocks:
                layers.append(dict(kind="res", ch=ch, out_ch=ch, up=True)
                              if cfg.resblock_updown else dict(kind="upsample", ch=ch))
                ds //= 2
            output_blocks.append(layers)

    return dict(input_blocks=input_blocks, middle_block=middle,
                output_blocks=output_blocks, out_ch=ch)


def _make_layer(cfg: UNetConfig, desc: Dict) -> nn.Module:
    kind = desc["kind"]
    if kind == "conv_in":
        # a plain conv, as sd_tpu's nn.Conv here: the int8 mode leaves it in bf16
        return nn.Conv2d(cfg.in_channels, desc["ch"], 3, padding=1)
    if kind == "res":
        return ResBlock(desc["ch"], 4 * cfg.model_channels, dropout=cfg.dropout,
                        out_channels=desc["out_ch"],
                        use_scale_shift_norm=cfg.use_scale_shift_norm,
                        up=desc.get("up", False), down=desc.get("down", False))
    if kind == "spatial_transformer":
        return SpatialTransformer(desc["ch"], desc["heads"], desc["dim_head"],
                                  depth=desc["depth"], dropout=cfg.dropout,
                                  context_dim=desc["context_dim"])
    if kind == "attention":
        return QKVAttentionBlock(desc["ch"], desc["heads"], desc["use_new_attention_order"])
    if kind == "downsample":
        return Downsample(desc["ch"], use_conv=cfg.conv_resample)
    if kind == "upsample":
        return Upsample(desc["ch"], use_conv=cfg.conv_resample)
    raise ValueError(kind)


class UNetModel(nn.Module):
    """``forward(x [B, C, H, W], timesteps [B], context [B, N, D], y [B])``
    (``y``, the class ids, given exactly where ``num_classes`` is set); runs
    in the parameters' dtype and returns the dtype of ``x``: ε ``[B, out, H,
    W]``, or with ``n_embed`` the codebook logits ``[B, n_embed, H, W]``."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        plan = build_unet_plan(cfg)
        emb_ch = 4 * cfg.model_channels
        self.time_embed = nn.Sequential(nn.Linear(cfg.model_channels, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))
        if cfg.num_classes is not None:
            self.label_emb = nn.Embedding(cfg.num_classes, emb_ch)
        blocks = lambda descs: nn.ModuleList(_make_layer(cfg, d) for d in descs)
        self.input_blocks = nn.ModuleList(blocks(b) for b in plan["input_blocks"])
        self.middle_block = blocks(plan["middle_block"])
        self.output_blocks = nn.ModuleList(blocks(b) for b in plan["output_blocks"])
        self.out = nn.Sequential(GroupNorm32(plan["out_ch"]), nn.SiLU(),
                                 nn.Conv2d(plan["out_ch"], cfg.out_channels, 3, padding=1))
        if cfg.n_embed is not None:
            self.id_predictor = nn.Sequential(GroupNorm32(plan["out_ch"]),
                                              nn.Conv2d(cfg.model_channels, cfg.n_embed, 1))

    def _run_block(self, layers: nn.ModuleList, h, emb, context):
        remat = self.config.use_checkpoint and self.training and torch.is_grad_enabled()
        for layer in layers:
            if isinstance(layer, (ResBlock, SpatialTransformer, QKVAttentionBlock)):
                args = ((emb,) if isinstance(layer, ResBlock) else
                        (context,) if isinstance(layer, SpatialTransformer) else ())
                if remat:
                    h = checkpoint(layer, h, *args, use_reentrant=False)
                else:
                    h = layer(h, *args)
            else:
                h = layer(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        if (y is not None) != (self.config.num_classes is not None):
            raise ValueError("y must be given exactly where the model is class-conditional")
        dtype = self.time_embed[0].weight.dtype
        t_emb = timestep_embedding(timesteps, self.config.model_channels)
        emb = self.time_embed(t_emb.to(dtype))
        if y is not None:
            emb = emb + self.label_emb(y)
        context = context.to(dtype) if context is not None else None
        h = x.to(dtype)
        hs = []
        for block in self.input_blocks:
            h = self._run_block(block, h, emb, context)
            hs.append(h)
        h = self._run_block(self.middle_block, h, emb, context)
        for block in self.output_blocks:
            h = self._run_block(block, torch.cat([h, hs.pop()], dim=1), emb, context)
        head = self.id_predictor if self.config.n_embed is not None else self.out
        return head(h).to(x.dtype)
