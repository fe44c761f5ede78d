"""Residual blocks and resampling layers, NCHW (port of ``sd_tpu/ops/resblock.py``).

- ``ResBlock``: the UNet block with timestep-embedding injection, and with
  ``up``/``down`` its in-block resample (nearest x2 or a 2x2 average pool)
  after the first norm and activation, applied to the branch and the skip.
- ``VAEResnetBlock``: the autoencoder block (eps 1e-6 GroupNorm, a 1x1
  ``nin_shortcut`` or with ``conv_shortcut`` a 3x3 one on a channel change,
  and with ``temb_channels`` a ``temb_proj`` of the timestep embedding added
  after ``conv1``, as ``TimestepVAEModel``'s blocks take it).
- ``Upsample`` (nearest x2, then a 3x3 conv with ``use_conv``),
  ``Downsample`` (a stride-2 3x3 conv, or without ``use_conv`` a 2x2
  average pool) and ``VAEDownsample`` (the autoencoder's: pad right and
  bottom by one, then a stride-2 3x3 conv with no padding; or the pool).

``ResBlock`` (without ``up``/``down``, as ``sd_tpu`` gates it) and
``VAEResnetBlock`` have ``sd_tpu``'s fused path: with
``conv_impl`` ``"force"`` (held from ``SD_TPU_FUSED_CONV``, see
``ops/cuda/fused_conv.py``), a block with dropout off or 0 whose two convs pass
:func:`_fused_pair_supported` runs as two K7 launches. The first normalizes
x with the GroupNorm folded from :func:`group_stats`, applies SiLU, runs
conv1 and emits the moments of its rounded raw output; the second GroupNorm's
statistics come from those moments with conv1's bias and the timestep
embedding folded in (:func:`_second_gn_folds`), and the second launch runs
conv2 with bias and skip. The fused path reads the same weights, so the
``state_dict`` is the same, and in the int8 mode it stays bf16 K7, as in
``sd_tpu``.

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
from sd_tpu_torch.ops.cuda.fused_conv import (fold_gn_affine, fused_conv3x3,
                                              fused_conv_enabled, fused_conv_supported,
                                              parse_fused_conv, repacked_weight)
from sd_tpu_torch.ops.cuda.winograd_conv import parse_conv_impl
from sd_tpu_torch.ops.norms import GroupNorm32, group_stats

__all__ = ["Upsample", "Downsample", "VAEDownsample", "ResBlock", "VAEResnetBlock",
           "set_conv_modes"]


def _fused_pair_supported(x_shape, out_ch: int, dtype: torch.dtype) -> bool:
    """Both convs of a block on NCHW ``x_shape`` pass K7's gate."""
    b, cin, h, w = x_shape
    return (fused_conv_supported(x_shape, (out_ch, cin, 3, 3), dtype)
            and fused_conv_supported((b, out_ch, h, w), (out_ch, out_ch, 3, 3), dtype))


def _takes_fused_path(block: nn.Module, dropout: nn.Dropout, conv2: nn.Module,
                      x: torch.Tensor) -> bool:
    """``sd_tpu``'s dispatch condition: no in-block resample, dropout off or
    0, the mode on, and both convs of the block supported at ``x``. Raises
    where it holds in a tensor-parallel block (``parallel/tp.py``), whose
    second conv sums over the ranks before its bias and the skip."""
    fused = (getattr(block, "resample", None) is None
             and (not block.training or dropout.p == 0.0) and fused_conv_enabled(block.conv_impl)
             and _fused_pair_supported(x.shape, conv2.out_channels, x.dtype))
    if fused and getattr(conv2, "tensor_parallel", False):
        raise ValueError("a tensor-parallel ResBlock does not run the fused conv mode (K7); "
                         "tensor parallelism runs SD_TPU_FUSED_CONV=auto")
    return fused


def _resample(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Nearest x2 (``"up"``) or a 2x2 average pool (``"down"``) of NCHW ``x``."""
    if kind == "up":
        return F.interpolate(x, scale_factor=2.0, mode="nearest")
    return F.avg_pool2d(x, 2)


def _second_gn_folds(s1, s2, hw: int, offset, num_groups: int):
    """Group statistics of (h + offset) from the per-channel sums ``s1`` and
    squares ``s2`` over H, W of h; ``offset [B, C]`` is what the kernel did
    not add (conv1's bias, the timestep embedding). Exact in fp32:
    E[(h+o)²] = E[h²] + 2 o E[h] + o² per channel, then the group mean."""
    b, c = s1.shape
    mean_c = s1 / hw
    meansq_c = s2 / hw
    e_c = mean_c + offset
    e2_c = meansq_c + 2.0 * offset * mean_c + offset.square()
    return (e_c.reshape(b, num_groups, c // num_groups).mean(-1),
            e2_c.reshape(b, num_groups, c // num_groups).mean(-1))


def _kernel_weight(conv: nn.Module, x: torch.Tensor):
    """K7's repacked weight of ``conv``, kept on the module, where autograd
    does not record (there the call repacks)."""
    if torch.is_grad_enabled() and (x.requires_grad or conv.weight.requires_grad):
        return None
    return repacked_weight(conv, x.dtype)


def _fused_pair(x, gn1, conv1, gn2, conv2, skip, offset_of):
    """The two K7 launches of a fused block. ``offset_of(b1)`` returns the
    second GroupNorm's channel offset [B, C] and its FiLM (scale, shift) or
    (None, None)."""
    m1, m2 = group_stats(x, gn1.num_groups)
    a1, d1 = fold_gn_affine(m1, m2, gn1.weight.float(), gn1.bias.float(), gn1.eps)
    h_raw, s1, s2 = fused_conv3x3(x, conv1.weight.to(x.dtype), a=a1, d=d1, emit_moments=True,
                                  wk=_kernel_weight(conv1, x))
    offset, extra_scale, extra_shift = offset_of(conv1.bias.float())
    mg, m2g = _second_gn_folds(s1, s2, x.shape[2] * x.shape[3], offset, gn2.num_groups)
    a2, d2 = fold_gn_affine(mg, m2g, gn2.weight.float(), gn2.bias.float(), gn2.eps,
                            extra_scale=extra_scale, channel_offset=offset,
                            extra_shift=extra_shift)
    return fused_conv3x3(h_raw, conv2.weight.to(x.dtype), a=a2, d=d2, bias=conv2.bias.float(),
                         skip=skip.to(x.dtype), wk=_kernel_weight(conv2, x))


class Upsample(nn.Module):
    """Nearest x2 upsample, then a 3x3 conv (``conv``) with ``use_conv``."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        if use_conv:
            self.conv = Conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _resample(x, "up")
        return self.conv(x) if hasattr(self, "conv") else x


class Downsample(nn.Module):
    """The UNet's downsample: a stride-2 3x3 conv (``op``), or without
    ``use_conv`` a 2x2 average pool."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        if use_conv:
            self.op = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x) if hasattr(self, "op") else _resample(x, "down")


class VAEDownsample(nn.Module):
    """The encoder's downsample (``conv``): asymmetric pad (0, 1) on H and W,
    then a stride-2 3x3 conv with no padding; without ``use_conv`` a 2x2
    average pool."""

    def __init__(self, channels: int, use_conv: bool = True):
        super().__init__()
        if use_conv:
            self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "conv"):
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return _resample(x, "down")


class ResBlock(nn.Module):
    """GroupNorm → SiLU → conv, + emb (or FiLM scale-shift), GroupNorm → SiLU
    → dropout → conv, + skip (identity, or on a channel change a 1x1 conv,
    or a 3x3 one with ``use_conv``). With ``up`` or ``down`` the branch and
    the skip are resampled after the first SiLU (``resample``: ``"up"``,
    ``"down"`` or None). ``conv_impl`` holds the fused conv mode
    (``"auto"``, ``"off"``, ``"force"``)."""

    conv_impl = "auto"

    def __init__(self, channels: int, emb_channels: int, dropout: float = 0.0,
                 out_channels: Optional[int] = None, use_scale_shift_norm: bool = False,
                 use_conv: bool = False, up: bool = False, down: bool = False):
        super().__init__()
        out_ch = out_channels or channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.resample = "up" if up else "down" if down else None
        self.in_layers = nn.Sequential(GroupNorm32(channels), nn.SiLU(),
                                       Conv3x3(channels, out_ch))
        self.emb_layers = nn.Sequential(
            nn.SiLU(), nn.Linear(emb_channels, 2 * out_ch if use_scale_shift_norm else out_ch))
        self.out_layers = nn.Sequential(GroupNorm32(out_ch), nn.SiLU(), nn.Dropout(dropout),
                                        Conv3x3(out_ch, out_ch))
        if out_ch == channels:
            self.skip_connection = nn.Identity()
        elif use_conv:
            self.skip_connection = Conv3x3(channels, out_ch)
        else:
            self.skip_connection = nn.Conv2d(channels, out_ch, 1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if _takes_fused_path(self, self.out_layers[2], self.out_layers[3], x):
            return self._fused(x, emb)
        if self.resample is None:
            h = self.in_layers(x)
        else:
            h = _resample(self.in_layers[:-1](x), self.resample)
            x = _resample(x, self.resample)
            h = self.in_layers[-1](h)
        emb_out = self.emb_layers(emb)[:, :, None, None]
        norm, rest = self.out_layers[0], self.out_layers[1:]
        if self.use_scale_shift_norm:
            scale, shift = emb_out.chunk(2, dim=1)
            h = rest(norm(h) * (1 + scale) + shift)
        else:
            h = rest(norm(h + emb_out))
        return self.skip_connection(x) + h

    def _fused(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """Both convs through K7, the second GroupNorm's statistics from the
        first launch's moments (``sd_tpu``'s ``ResBlock._fused``)."""
        ef = self.emb_layers(emb).float()

        def offset_of(b1):
            if self.use_scale_shift_norm:
                scale, shift = ef.chunk(2, dim=1)
                return b1[None, :].expand(ef.shape[0], -1), 1.0 + scale, shift
            return b1[None, :] + ef, None, None

        return _fused_pair(x, self.in_layers[0], self.in_layers[2], self.out_layers[0],
                           self.out_layers[3], self.skip_connection(x), offset_of)


class VAEResnetBlock(nn.Module):
    """Autoencoder residual block: on a channel change a 1x1 ``nin_shortcut``,
    or with ``conv_shortcut`` a 3x3 one; with ``temb_channels`` a
    ``temb_proj`` (``Linear(temb_channels, out)``) of SiLU(temb) added per
    channel after ``conv1``. ``conv_impl`` as in :class:`ResBlock`."""

    conv_impl = "auto"

    def __init__(self, in_channels: int, out_channels: Optional[int] = None,
                 dropout: float = 0.0, conv_shortcut: bool = False, temb_channels: int = 0):
        super().__init__()
        out_ch = out_channels or in_channels
        self.norm1 = GroupNorm32(in_channels, eps=1e-6)
        self.conv1 = Conv3x3(in_channels, out_ch)
        if temb_channels > 0:
            self.temb_proj = nn.Linear(temb_channels, out_ch)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = Conv3x3(out_ch, out_ch)
        if in_channels != out_ch:
            if conv_shortcut:
                self.conv_shortcut = Conv3x3(in_channels, out_ch)
            else:
                self.nin_shortcut = nn.Conv2d(in_channels, out_ch, 1)

    def _temb_out(self, temb: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """temb_proj(SiLU(temb)) ``[B, out]``, or None without either."""
        if temb is None or not hasattr(self, "temb_proj"):
            return None
        return self.temb_proj(F.silu(temb))

    def _skip(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "conv_shortcut"):
            return self.conv_shortcut(x)
        if hasattr(self, "nin_shortcut"):
            return self.nin_shortcut(x)
        return x

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if _takes_fused_path(self, self.dropout, self.conv2, x):
            return self._fused(x, temb)
        h = self.conv1(F.silu(self.norm1(x)))
        emb = self._temb_out(temb)
        if emb is not None:
            h = h + emb[:, :, None, None]
        h = self.conv2(self.dropout(F.silu(self.norm2(h))))
        return self._skip(x) + h

    def _fused(self, x: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        """Both convs through K7 (``sd_tpu``'s ``VAEResnetBlock._fused``): the
        timestep term enters the second GroupNorm's per-batch channel offset
        beside conv1's bias."""
        emb = self._temb_out(temb)

        def offset_of(b1):
            if emb is None:
                return b1[None, :].expand(x.shape[0], -1), None, None
            return b1[None, :] + emb.float(), None, None

        return _fused_pair(x, self.norm1, self.conv1, self.norm2, self.conv2, self._skip(x),
                           offset_of)


def set_conv_modes(module: nn.Module, fused_conv=None, conv_impl=None):
    """Hold the fused conv mode (``SD_TPU_FUSED_CONV``'s values) on every
    resnet block of ``module`` and the conv mode (``SD_TPU_CONV_IMPL``'s) on
    every ``Conv3x3``; None reads the variable. Returns both, parsed."""
    fused_conv, conv_impl = parse_fused_conv(fused_conv), parse_conv_impl(conv_impl)
    for m in module.modules():
        if isinstance(m, (ResBlock, VAEResnetBlock)):
            m.conv_impl = fused_conv
        elif isinstance(m, Conv3x3):
            m.impl = conv_impl
    return fused_conv, conv_impl
