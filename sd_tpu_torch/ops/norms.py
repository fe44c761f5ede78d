"""Normalization layers with fp32 statistics (port of ``sd_tpu/ops/norms.py``).

``GroupNorm32`` computes its statistics in float32 and casts the result back
to the activation dtype, with the single-pass variance clamped at zero: the
E[x²]−E[x]² form can round negative on near-constant inputs and make
``rsqrt`` return NaN. ``LayerNormFp32`` is the pre-LN of the transformer
blocks and CLIP. Both keep ``nn.GroupNorm``/``nn.LayerNorm``'s parameter
names (``weight``, ``bias``), as the CompVis checkpoints do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["GroupNorm32", "LayerNormFp32"]


class GroupNorm32(nn.GroupNorm):
    """GroupNorm over NCHW in fp32; eps 1e-5 in the UNet, 1e-6 in the VAE and
    the SpatialTransformer."""

    def __init__(self, num_channels: int, eps: float = 1e-5, num_groups: int = 32):
        super().__init__(num_groups, num_channels, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        g = self.num_groups
        xf = x.float()
        xg = xf.reshape(b, g, -1)
        mean = xg.mean(dim=-1)
        meansq = xg.square().mean(dim=-1)
        var = (meansq - mean.square()).clamp_min(0.0)
        rstd = torch.rsqrt(var + self.eps)
        # fold the (B, G) statistics with the affine into one multiply-add
        scale = self.weight.float()
        a = rstd.repeat_interleave(c // g, dim=-1) * scale
        shift = self.bias.float() - (mean * rstd).repeat_interleave(c // g, dim=-1) * scale
        bshape = (b, c) + (1,) * (x.ndim - 2)
        return (xf * a.reshape(bshape) + shift.reshape(bshape)).to(x.dtype)


class LayerNormFp32(nn.LayerNorm):
    """LayerNorm computed in fp32, output in the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)
