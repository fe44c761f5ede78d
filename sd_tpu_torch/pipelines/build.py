"""Build a ready txt2img pipeline (port of ``sd_tpu/pipelines/build.py``).

The model: the tiny test model, or a config (``config``: a YAML or JSON
file; SD v1's ``v1-inference.yaml`` by default, built from the port's own
copy of it) with seeded random weights, a reference ``.ckpt``'s weights,
or a training run's (``ckpt`` naming a run directory: the UNet's EMA
shadow by default, ``use_ema=False`` for its current parameters, and the
run's config). The tokenizer: the CLIP BPE tokenizer where
``SD_TPU_BPE_VOCAB`` names CLIP's merges file, else the hash tokenizer,
which a reference checkpoint refuses (``SystemExit``: its embeddings would
be read with the wrong ids). The safety checker, on by default:
``safety_ckpt`` (or ``SD_TPU_SAFETY_CKPT``), an HF
``StableDiffusionSafetyChecker`` ``state_dict``, else the untrained checker
that scores every image and flags none. The invisible watermark (the
port's copy in ``utils/watermark.py``).

``int8`` selects the int8 serving mode in ``SD_TPU_INT8``'s grammar
(``ops/quant.py``); None reads that variable, once, here. ``fused_conv`` and
``conv_impl`` select the conv modes (``SD_TPU_FUSED_CONV``: K7 at the resnet
blocks; ``SD_TPU_CONV_IMPL``: ``winograd`` for K8 at the 3x3 convs); None
reads those variables, here. ``precision`` is ``SD_TPU_PRECISION``'s policy,
as in ``sd_tpu``: bf16 on the card unless it says ``fp32`` (or
``float32``); None reads the variable. An fp32 model on the card runs the
plain versions where the kernels are (``ops/attention.py::takes_kernel``),
where ``sd_tpu`` runs its Pallas kernels in fp32.
"""

from __future__ import annotations

import os
import sys
from typing import Any, Dict, Optional, Tuple

import torch

from sd_tpu_torch.data.tokenizer import CLIPTokenizer, HashTokenizer
from sd_tpu_torch.ops.quant import parse_int8
from sd_tpu_torch.pipelines.safety import SafetyChecker, port_safety_checker
from sd_tpu_torch.pipelines.txt2img import Txt2ImgPipeline
from sd_tpu_torch.utils.checkpoint import is_run_path, run_config_path
from sd_tpu_torch.utils.config import (
    SD_V1_MODEL_CONFIG,
    build_latent_diffusion,
    build_latent_diffusion_from_run,
    load_yaml,
    tiny_sd_model_config,
)
from sd_tpu_torch.utils.port import load_torch_state_dict

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


def _model_config(config: Optional[str]) -> Dict[str, Any]:
    if config is None:
        return SD_V1_MODEL_CONFIG
    cfg = load_yaml(config)
    return cfg["model"] if "model" in cfg else cfg


def _first_stage_shape(model_cfg: Dict[str, Any]) -> Tuple[int, int]:
    """(latent channels, downsampling factor) of a config's KL first stage."""
    kl = model_cfg["params"]["first_stage_config"]["params"]
    return kl["embed_dim"], 2 ** (len(kl["ddconfig"]["ch_mult"]) - 1)


def build_txt2img_pipeline(*, tiny: bool = False, config: Optional[str] = None,
                           ckpt: Optional[str] = None, use_ema: bool = True,
                           safety: bool = True, safety_ckpt: Optional[str] = None,
                           device="cuda", seed: int = 0, watermark: bool = True,
                           min_hw: int = 512, latent_channels: Optional[int] = None,
                           downsample: Optional[int] = None, int8=None, fused_conv=None,
                           conv_impl=None, precision: Optional[str] = None
                           ) -> Tuple[Txt2ImgPipeline, Optional[int]]:
    """Returns ``(pipe, clamped_tiny_hw)``: 64 for the tiny model (callers
    clamp H and W to it), else None. ``min_hw`` is min(H, W) of the run; the
    watermark needs at least 32. ``latent_channels`` and ``downsample``
    default to the model config's first stage."""
    dtype = inference_dtype(device, precision)
    modes = dict(int8=parse_int8(int8), fused_conv=fused_conv, conv_impl=conv_impl)
    hw = None
    if tiny:
        model_cfg, hw = tiny_sd_model_config(), 64
        ldm = build_latent_diffusion(model_cfg, device=device, dtype=dtype, seed=seed, **modes)
        tok = HashTokenizer(64)
        tokenizer = lambda texts: tok(texts, context_length=8)
    else:
        bpe = os.environ.get("SD_TPU_BPE_VOCAB")
        state_dict = None
        if ckpt and is_run_path(ckpt):
            ldm, _ = build_latent_diffusion_from_run(ckpt, config, device=device, dtype=dtype,
                                                     use_ema=use_ema, **modes)
            model_cfg = _model_config(config or run_config_path(ckpt))
        else:
            model_cfg = _model_config(config)
            if ckpt:
                print(f"Loading state dict from {ckpt}", file=sys.stderr)
                state_dict = load_torch_state_dict(ckpt)
                if not bpe:
                    # the hash tokenizer's ids would index a real checkpoint's
                    # embeddings at random
                    raise SystemExit(
                        "Loaded a real checkpoint but no BPE vocab is configured: set "
                        "SD_TPU_BPE_VOCAB to the CLIP merges file "
                        "(bpe_simple_vocab_16e6.txt.gz). The hash tokenizer is only valid for "
                        "random-weight runs and the port's own training runs.")
            ldm = build_latent_diffusion(model_cfg, device=device, dtype=dtype, seed=seed,
                                         state_dict=state_dict, **modes)
        clip_p = model_cfg["params"]["cond_stage_config"].get("params") or {}
        context = clip_p.get("max_position_embeddings", 77)
        if bpe:
            tok = CLIPTokenizer.from_openai_gz(bpe)
        else:
            # a run of the port's trainer trained against this tokenizer
            tok = HashTokenizer(clip_p.get("vocab_size", 49408))
        tokenizer = lambda texts: tok(texts, context_length=context)
        channels, factor = _first_stage_shape(model_cfg)
        latent_channels = latent_channels or channels
        downsample = downsample or factor
    pipe = Txt2ImgPipeline(ldm=ldm, tokenizer=tokenizer,
                           latent_channels=4 if tiny else latent_channels,
                           downsample=2 if tiny else downsample)
    if safety:
        safety_ckpt = safety_ckpt or os.environ.get("SD_TPU_SAFETY_CKPT")
        if safety_ckpt:
            checker = port_safety_checker(load_torch_state_dict(safety_ckpt))
        else:
            print("safety checker: no trained weights; running with unreachable thresholds "
                  "(scores computed, nothing flagged); pass --safety_ckpt or "
                  "SD_TPU_SAFETY_CKPT to arm it", file=sys.stderr)
            checker = SafetyChecker.untrained()
        # the tower in the serving dtype; concepts and thresholds stay fp32
        checker.to(device).vision_model.to(dtype)
        pipe.safety_checker = checker
    if watermark and min(min_hw, hw or min_hw) >= 32:
        from sd_tpu_torch.utils.watermark import embed_watermark_batch

        pipe.watermarker = embed_watermark_batch
    return pipe, hw
