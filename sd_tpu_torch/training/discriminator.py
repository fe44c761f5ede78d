"""The PatchGAN discriminator of the VAE-GAN loss (port of
``NLayerDiscriminator`` from ``sd_tpu/training/discriminator.py``, taming's
pix2pix architecture).

A 4x4 stride-2 conv and LeakyReLU(0.2), then ``n_layers`` blocks of a 4x4
conv without bias (stride 2, the last stride 1), BatchNorm and LeakyReLU,
then a 4x4 one-channel head: patch logits ``[B, 1, h, w]``. Names follow
taming (``main.0``, ``main.2``, ``main.3`` ...). :func:`weights_init` is
taming's: convs N(0, 0.02), BatchNorm scales N(1, 0.02), BatchNorm and conv
biases 0.

BatchNorm follows ``sd_tpu`` (flax): in training the batch statistics
normalize (the biased variance) and the running statistics move by
momentum 0.1 toward the batch mean and the BIASED variance, where
PyTorch's BatchNorm would take the unbiased one. ``forward(x, stats)``
says what BatchNorm does: "update" (batch statistics, running statistics
moved: the discriminator's own step), "batch" (batch statistics, nothing
moved: the generator loss, as ``sd_tpu`` discards that mutation) or
"running" (eval).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["NLayerDiscriminator", "weights_init"]

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def _batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, stats: str) -> torch.Tensor:
    x = x.float()
    if stats == "running":
        mean, var = bn.running_mean, bn.running_var
    else:
        mean = x.mean(dim=(0, 2, 3))
        var = (x.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
        if stats == "update":
            with torch.no_grad():
                bn.running_mean.lerp_(mean.detach(), BN_MOMENTUM)
                bn.running_var.lerp_(var.detach(), BN_MOMENTUM)
                bn.num_batches_tracked.add_(1)
    shape = (1, -1, 1, 1)
    y = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS)
    return y * bn.weight.float().view(shape) + bn.bias.float().view(shape)


class NLayerDiscriminator(nn.Module):
    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        layers = [nn.Conv2d(input_nc, ndf, 4, 2, 1), nn.LeakyReLU(0.2)]
        mult = 1
        for n in range(1, n_layers + 1):
            prev, mult = mult, min(2 ** n, 8)
            layers += [nn.Conv2d(ndf * prev, ndf * mult, 4, 2 if n < n_layers else 1, 1,
                                 bias=False),
                       nn.BatchNorm2d(ndf * mult, eps=BN_EPS, momentum=BN_MOMENTUM),
                       nn.LeakyReLU(0.2)]
        layers.append(nn.Conv2d(ndf * mult, 1, 4, 1, 1))
        self.main = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, stats: str = "update") -> torch.Tensor:
        if stats not in ("update", "batch", "running"):
            raise ValueError(f"BatchNorm statistics {stats!r}: update, batch or running")
        for layer in self.main:
            if isinstance(layer, nn.BatchNorm2d):
                x = _batch_norm(layer, x, stats).to(x.dtype)
            else:
                x = layer(x)
        return x


@torch.no_grad()
def weights_init(module: nn.Module, generator: torch.Generator) -> None:
    """taming's ``weights_init``, drawn from ``generator``."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, 0.02, generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.normal_(1.0, 0.02, generator=generator)
            m.bias.zero_()
