"""The first stage's latent posterior (port of ``DiagonalGaussian`` and
``normal_kl`` from ``sd_tpu/core/distributions.py``).

Built from the VAE encoder's 2C-channel moments, channels split into (mean,
logvar) and logvar clamped to [-30, 20], as the reference does. Tensors are
NCHW, so the split is on dim 1. ``sample`` draws from a ``torch.Generator``
or takes the noise it is given (the tests hand both packages the same numpy
noise). ``kl`` and ``nll`` sum over every dimension but the batch, as the
reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import math

import torch

from sd_tpu_torch.core.draws import draw

__all__ = ["DiagonalGaussian", "normal_kl"]


@dataclasses.dataclass(frozen=True)
class DiagonalGaussian:
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(moments, 2, dim=1)
        return cls(mean=mean, logvar=logvar.clamp(-30.0, 20.0))

    def sample(self, generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reparameterized sample ``mean + exp(logvar / 2) * noise``; ``noise``
        defaults to a standard normal draw from ``generator`` (or a
        ``RowDraws``)."""
        if noise is None:
            noise = draw(torch.randn, self.mean.shape, generator, self.mean.device,
                         dtype=self.mean.dtype)
        return self.mean + torch.exp(0.5 * self.logvar) * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self, other: Optional["DiagonalGaussian"] = None) -> torch.Tensor:
        """KL divergence to ``other`` (N(0, I) by default), ``[B]``, in fp32."""
        dims = tuple(range(1, self.mean.ndim))
        mean, logvar = self.mean.float(), self.logvar.float()
        if other is None:
            return 0.5 * torch.sum(mean.square() + torch.exp(logvar) - 1.0 - logvar, dim=dims)
        o_mean, o_logvar = other.mean.float(), other.logvar.float()
        return 0.5 * torch.sum((mean - o_mean).square() / torch.exp(o_logvar)
                               + torch.exp(logvar) / torch.exp(o_logvar) - 1.0 - logvar + o_logvar,
                               dim=dims)

    def nll(self, sample: torch.Tensor, dims=None) -> torch.Tensor:
        """Negative log likelihood of ``sample``, summed over ``dims`` (every
        dimension but the batch by default), in fp32."""
        if dims is None:
            dims = tuple(range(1, self.mean.ndim))
        logvar = self.logvar.float()
        return 0.5 * torch.sum(math.log(2.0 * math.pi) + logvar
                               + (sample.float() - self.mean.float()).square()
                               / torch.exp(logvar), dim=dims)


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """Elementwise KL between two Gaussians given by mean and log variance."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2).square() * torch.exp(-logvar2))
