"""3x3 stride-1 convolution (port of ``sd_tpu/ops/conv.py``).

``Conv3x3`` dispatches as ``sd_tpu``'s does, in this order:

1. Winograd F(2x2,3x3), K8 (``ops/cuda/winograd_conv.py``), where ``impl``
   is ``"winograd"`` (held from ``SD_TPU_CONV_IMPL``) and
   :func:`winograd_supported` passes (bf16 on the card, ``sd_tpu``'s shape
   rules);
2. otherwise the W8A8 conv ``int8_conv3x3``, where the int8 mode's ``conv``
   bucket is on (``ops/quant.py``'s gate and threshold), on the weights
   quantized at load time;
3. otherwise ``F.conv2d`` (cuDNN on the card), as ``sd_tpu`` leaves it to XLA.

After Winograd the bias is added in the activation dtype, as in ``sd_tpu``.
Where autograd does not record, K8 reads U (the weight transform, rounded
to the activation dtype) from a copy the module keeps and rebuilds whenever
the weight is replaced or changed in place (:meth:`Conv3x3.winograd_u`);
``sd_tpu`` computes U inside its jitted program, where XLA can hoist it out
of the sampler's loop.
NCHW activations, OIHW weights as in the CompVis checkpoints.
"""

from __future__ import annotations

import torch
from torch import nn

from sd_tpu_torch.ops import quant
from sd_tpu_torch.ops.cuda.winograd_conv import (weight_transform, winograd_conv3x3,
                                                 winograd_supported)

__all__ = ["Conv3x3"]


class Conv3x3(quant.Int8Weights, nn.Conv2d):
    """``nn.Conv2d(cin, cout, 3, padding=1)``; ``impl`` holds the conv mode
    (``"auto"`` or ``"winograd"``) and ``int8`` the int8 serving mode
    (``quant.set_int8_mode``)."""

    int8_bucket = "conv"
    impl = "auto"

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=1)

    def int8_sources(self):
        return (self.weight,)

    def int8_quantize(self):
        kq, sw = quant.quantize_conv_kernel(self.weight)
        return {"kq": kq, "sw": sw}

    def winograd_u(self, dtype: torch.dtype) -> torch.Tensor:
        """K8's U [16, C, K] of the weight in ``dtype``: computed once per
        weight version, keyed as :meth:`int8_weights` keys its copies."""
        w = self.weight
        key = (w.data_ptr(), w.dtype, w.device, w._version, dtype)
        cache = getattr(self, "_winograd_cache", None)
        if cache is None or cache[0] != key:
            with torch.no_grad():
                cache = (key, weight_transform(w.to(dtype)).to(dtype).contiguous())
            self._winograd_cache = cache
        return cache[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "winograd" and winograd_supported(x.shape, self.weight.shape, x.dtype,
                                                          x.device):
            w = self.weight.to(x.dtype)
            recording = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
            u = None if recording else self.winograd_u(x.dtype)
            y = winograd_conv3x3(x, w, u)
            return y + self.bias.to(x.dtype)[:, None, None]
        if quant.int8_enabled(self.int8, x):
            qw = self.int8_weights()
            return quant.int8_conv3x3(x, self.weight, self.bias, (qw["kq"], qw["sw"]))
        return super().forward(x)
