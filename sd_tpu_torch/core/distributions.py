"""The first stage's latent posterior (port of ``DiagonalGaussian`` from
``sd_tpu/core/distributions.py``).

Built from the VAE encoder's 2C-channel moments, channels split into (mean,
logvar) and logvar clamped to [-30, 20], as the reference does. Tensors are
NCHW, so the split is on dim 1. ``sample`` draws from a ``torch.Generator``
or takes the noise it is given (the tests hand both packages the same numpy
noise).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["DiagonalGaussian"]


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
        defaults to a standard normal draw from ``generator``."""
        if noise is None:
            noise = torch.randn(self.mean.shape, generator=generator, device=self.mean.device,
                                dtype=self.mean.dtype)
        return self.mean + torch.exp(0.5 * self.logvar) * noise.to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean
