"""Residual blocks and resampling layers, NCHW (port of ``sd_tpu/ops/resblock.py``).

- ``ResBlock``: the UNet block with timestep-embedding injection, on
  ``sd_tpu``'s unfused path (the fused GN+SiLU+conv kernel is still to port).
- ``VAEResnetBlock``: the autoencoder block (eps 1e-6 GroupNorm, 1x1
  shortcut).
- ``Upsample`` (nearest x2 + 3x3 conv), ``Downsample`` (stride-2 3x3 conv)
  and ``VAEDownsample`` (the autoencoder's: pad right and bottom by one, then
  a stride-2 3x3 conv with no padding).

Submodule names follow the CompVis ``state_dict``
(``in_layers.0``/``in_layers.2``/``emb_layers.1``/``out_layers.0``/
``out_layers.3``/``skip_connection``; ``norm1``/``conv1``/...).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.ops.conv import Conv3x3
from sd_tpu_torch.ops.norms import GroupNorm32

__all__ = ["Upsample", "Downsample", "VAEDownsample", "ResBlock", "VAEResnetBlock"]


class Upsample(nn.Module):
    """Nearest x2 upsample + 3x3 conv (``conv``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class Downsample(nn.Module):
    """Stride-2 3x3 conv (``op``), the UNet's downsample."""

    def __init__(self, channels: int):
        super().__init__()
        self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class VAEDownsample(nn.Module):
    """The encoder's downsample (``conv``): asymmetric pad (0, 1) on H and W,
    then a stride-2 3x3 conv with no padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class ResBlock(nn.Module):
    """GroupNorm → SiLU → conv, + emb (or FiLM scale-shift), GroupNorm → SiLU
    → dropout → conv, + skip (identity, or 1x1 conv on a channel change)."""

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.0,
                 out_channels: Optional[int] = None, use_scale_shift_norm: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(),
                                       Conv3x3(channels, out_ch))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch))
        self.out_layers = nn.Sequential(GroupNorm32(out_ch), nn.SiLU(), nn.Dropout(dropout),
                                        Conv3x3(out_ch, out_ch))
        if out_ch == channels:
            self.skip_connection = nn.Identity()
        else:
            self.skip_connection = nn.Conv2d(channels, out_ch, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers(x)
        emb_out = self.emb_layers(emb)[:, :, None, None]
        norm, rest = self.out_layers[0], self.out_layers[1:]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = rest(norm(h) * (1 + scale) + shift)
        else:
            h = rest(norm(h + emb_out))
        return self.skip_connection(x) + h


class VAEResnetBlock(nn.Module):
    """Autoencoder residual block (no timestep embedding on the decode path),
    with a 1x1 ``nin_shortcut`` on a channel change."""

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 dropout: float = 0.0):
        super().__init__()
        out_ch = out_channels or in_channels
        self.norm1 = GroupNorm32(in_channels, eps=1e-6)
        self.conv1 = Conv3x3(in_channels, out_ch)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv3x3(out_ch, out_ch)
        if in_channels != out_ch:
            self.nin_shortcut = nn.Conv2d(in_channels, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(self.dropout(F.silu(self.norm2(h))))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h
