"""The first-stage extras, NCHW (port of ``sd_tpu/models/vae_extras.py``).

The remaining modules of the reference's
``ldm/modules/diffusionmodules/model.py``: ``SimpleDecoder``,
``UpsampleDecoder``, ``LatentRescaler``, ``MergedRescaleEncoder``,
``MergedRescaleDecoder``, ``Upsampler``, the functional ``resize``,
``FirstStagePostProcessor`` and ``TimestepVAEModel`` (the reference's
``Model``: the VAE's encoder-decoder topology with a timestep embedding fed
to every resnet block and the encoder's outputs concatenated into every up
block). Submodule names are the reference's (``SimpleDecoder``'s
``model.0`` to ``model.5``, ``norm_out``, ``conv_out``; ``LatentRescaler``'s
``res_block1.{i}``, ``attn``, ``res_block2.{i}``; ``TimestepVAEModel``'s
``temb.dense.{0,1}``, ``down.{i}.block.{j}``, ``mid.attn_1``,
``up.{i}.upsample.conv`` ...), so one reference-layout ``state_dict``
loads into both packages.

As in ``sd_tpu``, ``LatentRescaler``'s interpolation and :func:`resize` are
``jax.image.resize``'s (``ops/resize.py``): its "nearest" takes half-pixel
centres (``F.interpolate``'s ``nearest-exact``, not its ``nearest``) and its
"bilinear" antialiases where it shrinks. The single-head attention blocks
(``VAEAttnBlock``, head dim = channels, up to 1024 at ``ch`` 128 and
``ch_mult`` (1, 2, 4, 8)) go to K1 on the card.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.core.distributions import DiagonalGaussian
from sd_tpu_torch.models.vae import Decoder, Encoder
from sd_tpu_torch.ops.attention import VAEAttnBlock
from sd_tpu_torch.ops.conv import Conv3x3
from sd_tpu_torch.ops.norms import GroupNorm32
from sd_tpu_torch.ops.resblock import Upsample, VAEDownsample, VAEResnetBlock
from sd_tpu_torch.ops.resize import resize as _jax_resize

__all__ = ["SimpleDecoder", "UpsampleDecoder", "LatentRescaler", "MergedRescaleEncoder",
           "MergedRescaleDecoder", "Upsampler", "resize", "FirstStagePostProcessor",
           "TimestepVAEModel", "vae_timestep_embedding"]


class SimpleDecoder(nn.Module):
    """1x1 → three resnet blocks (C → 2C → 4C → 2C) → 1x1 → upsample with
    its conv → GroupNorm, SiLU, 3x3 out conv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        c = in_channels
        self.model = nn.ModuleList([
            nn.Conv2d(c, c, 1),
            VAEResnetBlock(c, 2 * c),
            VAEResnetBlock(2 * c, 4 * c),
            VAEResnetBlock(4 * c, 2 * c),
            nn.Conv2d(2 * c, c, 1),
            Upsample(c, use_conv=True)])
        self.norm_out = GroupNorm32(c, eps=1e-6)
        self.conv_out = nn.Conv2d(c, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.model:
            x = layer(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class UpsampleDecoder(nn.Module):
    """Per level ``num_res_blocks + 1`` resnet blocks to ``ch * ch_mult[i]``,
    an upsample with its conv between levels, then the out conv."""

    def __init__(self, in_channels: int, out_channels: int, ch: int, num_res_blocks: int,
                 resolution: int, ch_mult: Sequence[int] = (2, 2), dropout: float = 0.0):
        super().__init__()
        block_in = in_channels
        self.res_blocks = nn.ModuleList()
        self.upsample_blocks = nn.ModuleList()
        for i_level, mult in enumerate(ch_mult):
            block_out = ch * mult
            blocks = nn.ModuleList()
            for _ in range(num_res_blocks + 1):
                blocks.append(VAEResnetBlock(block_in, block_out, dropout=dropout))
                block_in = block_out
            self.res_blocks.append(blocks)
            if i_level != len(ch_mult) - 1:
                self.upsample_blocks.append(Upsample(block_in, use_conv=True))
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = nn.Conv2d(block_in, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i_level, blocks in enumerate(self.res_blocks):
            for block in blocks:
                x = block(x)
            if i_level != len(self.res_blocks) - 1:
                x = self.upsample_blocks[i_level](x)
        return self.conv_out(F.silu(self.norm_out(x)))


class LatentRescaler(nn.Module):
    """3x3 in conv → ``depth`` resnet blocks → nearest resize by ``factor``
    (``jax.image.resize``'s) → attention → ``depth`` resnet blocks → 1x1 out
    conv."""

    def __init__(self, factor: float, in_channels: int, mid_channels: int, out_channels: int,
                 depth: int = 2):
        super().__init__()
        self.factor = factor
        self.conv_in = nn.Conv2d(in_channels, mid_channels, 3, padding=1)
        self.res_block1 = nn.ModuleList(VAEResnetBlock(mid_channels) for _ in range(depth))
        self.attn = VAEAttnBlock(mid_channels)
        self.res_block2 = nn.ModuleList(VAEResnetBlock(mid_channels) for _ in range(depth))
        self.conv_out = nn.Conv2d(mid_channels, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.res_block1:
            x = block(x)
        h, w = x.shape[-2:]
        x = _jax_resize(x, (int(round(h * self.factor)), int(round(w * self.factor))),
                        "nearest")
        x = self.attn(x)
        for block in self.res_block2:
            x = block(x)
        return self.conv_out(x)


class MergedRescaleEncoder(nn.Module):
    """The encoder (``z_channels`` = ``ch * ch_mult[-1]``, no ``double_z``),
    then a ``LatentRescaler`` to ``out_ch`` channels."""

    def __init__(self, in_channels: int, ch: int, resolution: int, out_ch: int,
                 num_res_blocks: int, attn_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, resamp_with_conv: bool = True,
                 ch_mult: Sequence[int] = (1, 2, 4, 8), rescale_factor: float = 1.0,
                 rescale_module_depth: int = 1):
        super().__init__()
        inter = ch * ch_mult[-1]
        self.encoder = Encoder(in_channels=in_channels, num_res_blocks=num_res_blocks, ch=ch,
                               ch_mult=ch_mult, z_channels=inter, double_z=False,
                               resolution=resolution, attn_resolutions=attn_resolutions,
                               dropout=dropout, resamp_with_conv=resamp_with_conv)
        self.rescaler = LatentRescaler(factor=rescale_factor, in_channels=inter,
                                       mid_channels=inter, out_channels=out_ch,
                                       depth=rescale_module_depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rescaler(self.encoder(x))


class MergedRescaleDecoder(nn.Module):
    """A ``LatentRescaler`` from ``z_channels`` to ``z_channels * ch_mult[-1]``,
    then the decoder."""

    def __init__(self, z_channels: int, out_ch: int, resolution: int, num_res_blocks: int,
                 attn_resolutions: Sequence[int] = (), ch: int = 128,
                 ch_mult: Sequence[int] = (1, 2, 4, 8), dropout: float = 0.0,
                 resamp_with_conv: bool = True, rescale_factor: float = 1.0,
                 rescale_module_depth: int = 1):
        super().__init__()
        tmp = z_channels * ch_mult[-1]
        self.decoder = Decoder(out_ch=out_ch, z_channels=tmp, attn_resolutions=attn_resolutions,
                               dropout=dropout, resamp_with_conv=resamp_with_conv,
                               num_res_blocks=num_res_blocks, ch_mult=ch_mult,
                               resolution=resolution, ch=ch)
        self.rescaler = LatentRescaler(factor=rescale_factor, in_channels=z_channels,
                                       mid_channels=tmp, out_channels=tmp,
                                       depth=rescale_module_depth)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.rescaler(x))


class Upsampler(nn.Module):
    """A ``LatentRescaler`` (factor ``1 + out_size % in_size``, the
    reference's own formula) and a decoder of ``log2(out / in) + 1`` levels
    of ``ch_mult`` each, from ``in_size`` to ``out_size``."""

    def __init__(self, in_size: int, out_size: int, in_channels: int, out_channels: int,
                 ch_mult: int = 2):
        super().__init__()
        if out_size < in_size:
            raise ValueError(f"Upsampler: out_size {out_size} below in_size {in_size}")
        num_blocks = int(np.log2(out_size // in_size)) + 1
        factor_up = 1.0 + (out_size % in_size)
        self.rescaler = LatentRescaler(factor=factor_up, in_channels=in_channels,
                                       mid_channels=2 * in_channels, out_channels=in_channels)
        self.decoder = Decoder(out_ch=out_channels, resolution=out_size, z_channels=in_channels,
                               num_res_blocks=2, attn_resolutions=[], ch=in_channels,
                               ch_mult=[ch_mult] * num_blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.rescaler(x))


def resize(x: torch.Tensor, scale_factor: float = 1.0, mode: str = "bilinear") -> torch.Tensor:
    """The reference's functional ``Resize`` on ``[B, C, H, W]``: to
    ``int(H * scale_factor) x int(W * scale_factor)`` as ``jax.image.resize``
    gives it (antialiased where it shrinks); the identity at 1."""
    if scale_factor == 1.0:
        return x
    h, w = x.shape[-2:]
    return _jax_resize(x, (int(h * scale_factor), int(w * scale_factor)), mode)


class FirstStagePostProcessor(nn.Module):
    """A frozen first stage's latents into conditioning features:
    GroupNorm of ``in_channels // 2`` groups, a 3x3 projection to
    ``n_channels``, SiLU, then per ``ch_mult`` entry a resnet block and a 2x2
    average pool; with ``reshape`` the tokens ``[B, H·W, C]``. The caller
    encodes with the frozen model (a KL stage's posterior is taken at its
    mode here), as ``sd_tpu`` binds it at call time."""

    def __init__(self, ch_mult: Sequence[int], in_channels: int, n_channels: int,
                 reshape: bool = False, dropout: float = 0.0):
        super().__init__()
        self.do_reshape = reshape
        self.proj_norm = GroupNorm32(in_channels, eps=1e-6, num_groups=in_channels // 2)
        self.proj = nn.Conv2d(in_channels, n_channels, 3, padding=1)
        blocks, ch_in = [], n_channels
        for m in ch_mult:
            blocks.append(VAEResnetBlock(ch_in, m * n_channels, dropout=dropout))
            ch_in = m * n_channels
        self.model = nn.ModuleList(blocks)

    def forward(self, z_fs) -> torch.Tensor:
        if isinstance(z_fs, DiagonalGaussian):
            z_fs = z_fs.mode()
        z = F.silu(self.proj(self.proj_norm(z_fs)))
        for block in self.model:
            z = F.avg_pool2d(block(z), 2)  # the reference's Downsample without a conv
        if self.do_reshape:
            b, c, h, w = z.shape
            z = z.permute(0, 2, 3, 1).reshape(b, h * w, c)
        return z


def vae_timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """The reference's ``get_timestep_embedding``: frequencies over
    ``half - 1`` and sin before cos, unlike the UNet's embedding; fp32
    ``[B, dim]``."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepVAEModel(nn.Module):
    """The timestep-conditioned encoder-decoder with UNet skips (the
    reference's ``Model``): ``forward(x, t, context)``, ``context``
    concatenated to x along the channels before ``conv_in`` (``in_channels``
    counts both), the timestep embedding (``temb.dense``) fed to every
    resnet block, and every encoder output concatenated into an up block
    (``num_res_blocks + 1`` a level). Every block holds its ``temb_proj``,
    as the reference's do. The reference's ``use_timestep`` and
    ``attn_type`` are fixed at their defaults: always the timestep, always
    the vanilla attention."""

    def __init__(self, *, ch: int, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (),
                 dropout: float = 0.0, resamp_with_conv: bool = True, in_channels: int = 3,
                 resolution: int = 256):
        super().__init__()
        self.ch = ch
        temb_ch = 4 * ch
        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([nn.Linear(ch, temb_ch), nn.Linear(temb_ch, temb_ch)])
        num_res = len(ch_mult)
        in_ch_mult = (1,) + tuple(ch_mult)
        curr_res = resolution
        self.conv_in = Conv3x3(in_channels, ch)
        self.down = nn.ModuleList()
        for i_level in range(num_res):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_in = ch * in_ch_mult[i_level]
            block_out = ch * ch_mult[i_level]
            for _ in range(num_res_blocks):
                level.block.append(VAEResnetBlock(block_in, block_out, dropout=dropout,
                                                  temb_channels=temb_ch))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(VAEAttnBlock(block_in))
            if i_level != num_res - 1:
                level.downsample = VAEDownsample(block_in, resamp_with_conv)
                curr_res //= 2
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = VAEResnetBlock(block_in, dropout=dropout, temb_channels=temb_ch)
        self.mid.attn_1 = VAEAttnBlock(block_in)
        self.mid.block_2 = VAEResnetBlock(block_in, dropout=dropout, temb_channels=temb_ch)
        up = [None] * num_res
        for i_level in reversed(range(num_res)):
            level = nn.Module()
            level.block = nn.ModuleList()
            level.attn = nn.ModuleList()
            block_out = ch * ch_mult[i_level]
            for i_block in range(num_res_blocks + 1):
                skip_in = ch * (in_ch_mult[i_level] if i_block == num_res_blocks
                                else ch_mult[i_level])
                level.block.append(VAEResnetBlock(block_in + skip_in, block_out,
                                                  dropout=dropout, temb_channels=temb_ch))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(VAEAttnBlock(block_in))
            if i_level != 0:
                level.upsample = Upsample(block_in, resamp_with_conv)
                curr_res *= 2
            up[i_level] = level
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm32(block_in, eps=1e-6)
        self.conv_out = Conv3x3(block_in, out_ch)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        if context is not None:
            x = torch.cat([x, context], dim=1)
        dense = self.temb.dense
        temb = dense[0](vae_timestep_embedding(t, self.ch).to(dense[0].weight.dtype))
        temb = dense[1](F.silu(temb))
        hs = [self.conv_in(x)]
        for i_level, level in enumerate(self.down):
            for i_block, block in enumerate(level.block):
                h = block(hs[-1], temb)
                if len(level.attn):
                    h = level.attn[i_block](h)
                hs.append(h)
            if i_level != len(self.down) - 1:
                hs.append(level.downsample(hs[-1]))
        h = self.mid.block_1(hs[-1], temb)
        h = self.mid.block_2(self.mid.attn_1(h), temb)
        for i_level in reversed(range(len(self.up))):
            level = self.up[i_level]
            for i_block, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb)
                if len(level.attn):
                    h = level.attn[i_block](h)
            if i_level != 0:
                h = level.upsample(h)
        return self.conv_out(F.silu(self.norm_out(h)))
