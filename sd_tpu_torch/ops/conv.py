"""3x3 stride-1 convolution (port of ``sd_tpu/ops/conv.py`` on its direct path).

``sd_tpu`` leaves this conv to XLA, so the port leaves it to ``F.conv2d``
(cuDNN on the card). NCHW activations, OIHW weights as in the CompVis
checkpoints.
"""

from __future__ import annotations

from torch import nn

__all__ = ["Conv3x3"]


class Conv3x3(nn.Conv2d):
    """``nn.Conv2d(cin, cout, 3, padding=1)``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)
