"""VGG16's conv trunk, the backbone of the LPIPS loss (port of
``VGG16Features`` from ``sd_tpu/models/vgg.py``).

Layers keep torchvision's ``vgg16().features`` indices (``features.0``,
``features.2``, ... ``features.28``; ReLUs and max pools between), so a
torchvision state_dict loads as it is. The forward returns the five LPIPS
taps: after relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3 (the trunk's
last max pool is not run).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

__all__ = ["VGG16Features", "TAPS"]

# conv widths, "M" a 2x2 max pool: torchvision's configuration "D"
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
# the features index of the ReLU after which each tap is read
TAPS = {"relu1_2": 3, "relu2_2": 8, "relu3_3": 15, "relu4_3": 22, "relu5_3": 29}


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        layers, c = [], 3
        for item in _CFG:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(c, item, 3, padding=1), nn.ReLU()]
                c = item
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Images ``[B, 3, H, W]`` → the five tap activations by name."""
        at = {i: name for name, i in TAPS.items()}
        taps = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in at:
                taps[at[i]] = x
        return taps
