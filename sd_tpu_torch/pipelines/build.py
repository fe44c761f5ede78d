"""Build a ready txt2img pipeline (port of ``sd_tpu/pipelines/build.py``).

SD v1 at full width, or the tiny test model, with seeded random weights on
the target device (no checkpoint loading yet), the hash tokenizer, and the
invisible watermark (the port's copies in ``data/tokenizer.py`` and
``utils/watermark.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sd_tpu_torch.data.tokenizer import HashTokenizer
from sd_tpu_torch.pipelines.txt2img import Txt2ImgPipeline
from sd_tpu_torch.utils.config import (
    SD_V1_MODEL_CONFIG,
    build_latent_diffusion,
    tiny_sd_model_config,
)

__all__ = ["build_txt2img_pipeline", "inference_dtype"]


def inference_dtype(device) -> torch.dtype:
    """bf16 on the card (the kernels' path; norms and softmax keep fp32
    islands inside the modules), fp32 on the CPU."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32


def build_txt2img_pipeline(*, tiny: bool = False, device="cuda", seed: int = 0,
                           watermark: bool = True, min_hw: int = 512
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
    ldm = build_latent_diffusion(model_cfg, device=device, dtype=inference_dtype(device),
                                 seed=seed)
    pipe = Txt2ImgPipeline(ldm=ldm, tokenizer=tokenizer, downsample=downsample)
    if watermark and min(min_hw, hw or min_hw) >= 32:
        from sd_tpu_torch.utils.watermark import embed_watermark_batch

        pipe.watermarker = embed_watermark_batch
    return pipe, hw
