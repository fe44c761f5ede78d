"""The LPIPS perceptual distance (port of ``LPIPS`` from
``sd_tpu/training/lpips.py``).

Both images are shifted and scaled by lpips' ImageNet constants, run
through VGG16's trunk; at each of the five taps the activations are
normalized to unit length over channels, their squared difference weighted
by a learned 1x1 head (``lin{i}.model.1``, no bias) and averaged over
space; the five are summed: ``[B, 1, 1, 1]``. Names follow lpips
(``lin{i}.model.1.weight``) and torchvision (``vgg.features.*``); the
released weights are not in the repository, so the loss is built from
seeded random weights or ``sd_tpu``'s parameters (``utils/convert.py``).
The module is frozen: the loss trains nothing in it.
"""

from __future__ import annotations

import torch
from torch import nn

from sd_tpu_torch.models.vgg import TAPS, VGG16Features

__all__ = ["LPIPS"]

_CHANNELS = [64, 128, 256, 512, 512]
# lpips' ScalingLayer, for inputs in [-1, 1]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x.square(), dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, c in enumerate(_CHANNELS):
            lin = nn.Module()
            # index 0 is lpips' dropout, which its loss runs in eval mode
            lin.model = nn.Sequential(nn.Identity(), nn.Conv2d(c, 1, 1, bias=False))
            self.add_module(f"lin{i}", lin)
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Distance between two ``[B, 3, H, W]`` batches in [-1, 1]."""
        fx = self.vgg((x - self.shift.to(x.dtype)) / self.scale.to(x.dtype))
        fy = self.vgg((y - self.shift.to(y.dtype)) / self.scale.to(y.dtype))
        total = 0.0
        for i, tap in enumerate(TAPS):
            d = (_unit_normalize(fx[tap]) - _unit_normalize(fy[tap])).square()
            total = total + getattr(self, f"lin{i}").model(d).mean(dim=(2, 3), keepdim=True)
        return total
