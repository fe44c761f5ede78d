"""3x3 stride-1 convolution (port of ``sd_tpu/ops/conv.py``).

``sd_tpu`` leaves this conv to XLA, so the port leaves it to ``F.conv2d``
(cuDNN on the card), except in the int8 serving mode: where the ``conv``
bucket is on (``ops/quant.py``'s gate and threshold), it runs the W8A8 conv
``int8_conv3x3`` on the weights quantized at load time. NCHW activations,
OIHW weights as in the CompVis checkpoints.
"""

from __future__ import annotations

import torch
from torch import nn

from sd_tpu_torch.ops import quant

__all__ = ["Conv3x3"]


class Conv3x3(quant.Int8Weights, nn.Conv2d):
    """``nn.Conv2d(cin, cout, 3, padding=1)``; ``int8`` holds the serving
    mode (``quant.set_int8_mode``)."""

    int8_bucket = "conv"

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)

    def int8_sources(self):
        return (self.weight,)

    def int8_quantize(self):
        kq, sw = quant.quantize_conv_kernel(self.weight)
        return {"kq": kq, "sw": sw}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if quant.int8_enabled(self.int8, x):
            qw = self.int8_weights()
            return quant.int8_conv3x3(x, self.weight, self.bias, (qw["kq"], qw["sw"]))
        return super().forward(x)
