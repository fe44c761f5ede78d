"""Build a ready txt2img pipeline (port of ``sd_tpu/pipelines/build.py``).

SD v1 at full width, or the tiny test model, with seeded random weights on
the target device (no checkpoint loading yet), the hash tokenizer, and the
invisible watermark (the port's copies in ``data/tokenizer.py`` and
``utils/watermark.py``). ``int8`` selects the int8 serving mode in
``SD_TPU_INT8``'s grammar (``ops/quant.py``); None reads that variable, once,
here. ``fused_conv`` and ``conv_impl`` select the conv modes
(``SD_TPU_FUSED_CONV``: K7 at the resnet blocks; ``SD_TPU_CONV_IMPL``:
``winograd`` for K8 at the 3x3 convs); None reads those variables, here.
``precision`` is ``SD_TPU_PRECISION``'s policy, as in ``sd_tpu``: bf16 on
the card unless it says ``fp32`` (or ``float32``); None reads the variable.
An fp32 model on the card runs the plain versions where the kernels are
(``ops/attention.py::takes_kernel``), where ``sd_tpu`` runs its Pallas
kernels in fp32.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from sd_tpu_torch.data.tokenizer import HashTokenizer
from sd_tpu_torch.ops.quant import parse_int8
from sd_tpu_torch.pipelines.txt2img import Txt2ImgPipeline
from sd_tpu_torch.utils.config import (
    SD_V1_MODEL_CONFIG,
    build_latent_diffusion,
    tiny_sd_model_config,
)

__all__ = ["build_txt2img_pipeline", "inference_dtype"]


def inference_dtype(device, precision: Optional[str] = None) -> torch.dtype:
    """bf16 on the card (the kernels' path; norms and softmax keep fp32
    islands inside the modules) unless ``precision`` (None: the variable
    ``SD_TPU_PRECISION``) is ``fp32`` or ``float32``; fp32 on the CPU."""
    if precision is None:
        precision = os.environ.get("SD_TPU_PRECISION", "bf16")
    if torch.device(device).type != "cuda" or precision.lower() in ("fp32", "float32"):
        return torch.float32
    return torch.bfloat16


def build_txt2img_pipeline(*, tiny: bool = False, device="cuda", seed: int = 0,
                           watermark: bool = True, min_hw: int = 512, int8=None,
                           fused_conv=None, conv_impl=None, precision: Optional[str] = None
                           ) -> Tuple[Txt2ImgPipeline, Optional[int]]:
    """Returns ``(pipe, clamped_tiny_hw)``: 64 for the tiny model (callers
    clamp H and W to it), else None. ``min_hw`` is min(H, W) of the run; the
    watermark needs at least 32."""
    if tiny:
        model_cfg, hw, downsample = tiny_sd_model_config(), 64, 2
        tok = HashTokenizer(64)
        tokenizer = lambda texts: tok(texts, context_length=8)
    else:
        model_cfg, hw, downsample = SD_V1_MODEL_CONFIG, None, 8
        tokenizer = HashTokenizer()
    ldm = build_latent_diffusion(model_cfg, device=device,
                                 dtype=inference_dtype(device, precision),
                                 seed=seed, int8=parse_int8(int8), fused_conv=fused_conv,
                                 conv_impl=conv_impl)
    pipe = Txt2ImgPipeline(ldm=ldm, tokenizer=tokenizer, downsample=downsample)
    if watermark and min(min_hw, hw or min_hw) >= 32:
        from sd_tpu_torch.utils.watermark import embed_watermark_batch

        pipe.watermarker = embed_watermark_batch
    return pipe, hw
