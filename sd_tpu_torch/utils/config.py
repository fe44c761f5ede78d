"""Model and data configs and ``build_latent_diffusion`` (the slice of
``sd_tpu/utils/config.py`` that builds SD v1 and the tiny test model).

The card has no YAML parser, so SD v1's model config lives here as a dict;
a CPU test holds it equal to ``configs/stable-diffusion/v1-inference.yaml``.
:func:`train_config` adds a ``data`` node to either model: synthetic images
with token captions under the model's ``cond_stage_key`` (no dataset is in
the repository). :func:`build_latent_diffusion` makes random weights on the
target device from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
from torch import nn

from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.models.clip import CLIPTextConfig
from sd_tpu_torch.models.ldm import LatentDiffusion
from sd_tpu_torch.models.unet import UNetConfig

__all__ = ["SD_V1_MODEL_CONFIG", "tiny_sd_model_config", "train_config",
           "build_latent_diffusion", "init_random_"]

# the `model:` node of configs/stable-diffusion/v1-inference.yaml
SD_V1_MODEL_CONFIG: Dict[str, Any] = {
    "base_learning_rate": 1.0e-04,
    "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
    "params": {
        "linear_start": 0.00085,
        "linear_end": 0.0120,
        "num_timesteps_cond": 1,
        "log_every_t": 200,
        "timesteps": 1000,
        "first_stage_key": "jpg",
        "cond_stage_key": "txt",
        "image_size": 64,
        "channels": 4,
        "cond_stage_trainable": False,
        "conditioning_key": "crossattn",
        "monitor": "val/loss_simple_ema",
        "scale_factor": 0.18215,
        "use_ema": False,
        "scheduler_config": {
            "target": "ldm.lr_scheduler.LambdaLinearScheduler",
            "params": {
                "warm_up_steps": [10000],
                "cycle_lengths": [10000000000000],
                "f_start": [1.e-6],
                "f_max": [1.],
                "f_min": [1.],
            },
        },
        "unet_config": {
            "target": "ldm.modules.diffusionmodules.openaimodel.UNetModel",
            "params": {
                "image_size": 32,
                "in_channels": 4,
                "out_channels": 4,
                "model_channels": 320,
                "attention_resolutions": [4, 2, 1],
                "num_res_blocks": 2,
                "channel_mult": [1, 2, 4, 4],
                "num_heads": 8,
                "use_spatial_transformer": True,
                "transformer_depth": 1,
                "context_dim": 768,
                "use_checkpoint": True,
                "legacy": False,
            },
        },
        "first_stage_config": {
            "target": "ldm.models.autoencoder.AutoencoderKL",
            "params": {
                "embed_dim": 4,
                "monitor": "val/rec_loss",
                "ddconfig": {
                    "double_z": True,
                    "z_channels": 4,
                    "resolution": 256,
                    "in_channels": 3,
                    "out_ch": 3,
                    "ch": 128,
                    "ch_mult": [1, 2, 4, 4],
                    "num_res_blocks": 2,
                    "attn_resolutions": [],
                    "dropout": 0.0,
                },
            },
        },
        "cond_stage_config": {
            "target": "ldm.modules.encoders.modules.FrozenCLIPEmbedder",
        },
    },
}

_UNET_TARGET = "ldm.modules.diffusionmodules.openaimodel.UNetModel"
_KL_TARGET = "ldm.models.autoencoder.AutoencoderKL"
_CLIP_TARGET = "ldm.modules.encoders.modules.FrozenCLIPEmbedder"


def tiny_sd_model_config() -> Dict[str, Any]:
    """SD-shaped and tiny: the UNet and f2 KL decoder of
    ``sd_tpu.utils.testing.tiny_sd_model_config`` (context 32) with a narrow
    CLIP text tower (hidden 32, 2 layers, 4 heads, vocab 64, 8 positions)."""
    return {
        "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
        "params": {
            "linear_start": 0.00085,
            "linear_end": 0.012,
            "timesteps": 1000,
            "image_size": 16,
            "channels": 4,
            "scale_factor": 0.18215,
            "conditioning_key": "crossattn",
            "unet_config": {
                "target": _UNET_TARGET,
                "params": {
                    "image_size": 16, "in_channels": 4, "out_channels": 4,
                    "model_channels": 32, "attention_resolutions": [2],
                    "num_res_blocks": 1, "channel_mult": [1, 2], "num_heads": 4,
                    "use_spatial_transformer": True, "transformer_depth": 1,
                    "context_dim": 32,
                },
            },
            "first_stage_config": {
                "target": _KL_TARGET,
                "params": {
                    "embed_dim": 4,
                    "ddconfig": {
                        "double_z": True, "z_channels": 4, "resolution": 32,
                        "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2],
                        "num_res_blocks": 1, "attn_resolutions": [], "dropout": 0.0,
                    },
                },
            },
            "cond_stage_config": {
                "target": _CLIP_TARGET,
                "params": {
                    "vocab_size": 64, "hidden_size": 32, "intermediate_size": 64,
                    "num_hidden_layers": 2, "num_attention_heads": 4,
                    "max_position_embeddings": 8, "projection_dim": 32,
                    "eos_token_id": 63,
                },
            },
        },
    }


def train_config(tiny: bool = False, batch_size: Optional[int] = None) -> Dict[str, Any]:
    """``{"model": ..., "data": ...}`` for training SD v1 (512² images, 77
    token ids under ``txt``, batch 4) or the tiny model (32² images, 8 ids
    under ``caption``, batch 2) on ``SyntheticImages``."""
    if tiny:
        model = tiny_sd_model_config()
        images = dict(size=32, length=64, caption_tokens=8, caption_vocab=64)
        batch = 2
    else:
        model = copy.deepcopy(SD_V1_MODEL_CONFIG)
        images = dict(size=512, length=1024, caption_tokens=77, caption_vocab=49408)
        batch = 4
    key = model["params"].get("cond_stage_key", "caption")
    train = {"target": "sd_tpu_torch.data.synthetic.SyntheticImages",
             "params": dict(images, caption_key=key, seed=0)}
    return {"model": model,
            "data": {"params": {"batch_size": batch_size or batch, "train": train}}}


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> None:
    """Non-zero random weights everywhere, so every site carries signal:
    matrices and kernels N(0, 1/fan_in), norm scales N(1, 0.1²), biases
    N(0, 0.02²)."""
    for name, p in module.named_parameters():
        if p.ndim >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        elif name.endswith("weight"):
            p.normal_(1.0, 0.1, generator=generator)
        else:
            p.normal_(0.0, 0.02, generator=generator)


def _check_target(node: Dict[str, Any], target: str) -> Dict[str, Any]:
    if node.get("target") != target:
        raise NotImplementedError(f"the port builds {target}, not {node.get('target')!r}")
    return dict(node.get("params") or {})


def build_latent_diffusion(model_cfg: Dict[str, Any], *, device, dtype=torch.float32,
                           seed: int = 0, int8="off", fused_conv=None,
                           conv_impl=None) -> LatentDiffusion:
    """Build a :class:`LatentDiffusion` from a config's ``model`` node on
    ``device`` in ``dtype``, with random weights from
    ``torch.Generator(device).manual_seed(seed)``, and the int8 serving mode
    ``int8`` (``SD_TPU_INT8``'s grammar; off by default) held on its sites,
    with the weights it reads quantized after the cast to ``dtype``
    (``sd_tpu``'s ``maybe_weight_quant_overlay``), and the conv modes
    ``fused_conv`` and ``conv_impl`` (``SD_TPU_FUSED_CONV``'s and
    ``SD_TPU_CONV_IMPL``'s values; None reads the variable, here, once)."""
    p = copy.deepcopy(model_cfg.get("params") or {})
    if p.get("conditioning_key", "crossattn") != "crossattn":
        raise NotImplementedError("the port has crossattn conditioning only")
    unet_p = _check_target(p["unet_config"], _UNET_TARGET)
    kl_p = _check_target(p["first_stage_config"], _KL_TARGET)
    clip_p = _check_target(p["cond_stage_config"], _CLIP_TARGET)
    schedule = DiffusionSchedule.create(
        timesteps=p.get("timesteps", 1000), beta_schedule=p.get("beta_schedule", "linear"),
        linear_start=p.get("linear_start", 1e-4), linear_end=p.get("linear_end", 2e-2),
        cosine_s=p.get("cosine_s", 8e-3), v_posterior=p.get("v_posterior", 0.0),
        parameterization=p.get("parameterization", "eps"))
    with torch.device("meta"):
        ldm = LatentDiffusion(UNetConfig.from_dict(unet_p), kl_p["ddconfig"],
                              kl_p["embed_dim"], CLIPTextConfig(**clip_p), schedule,
                              scale_factor=p.get("scale_factor", 1.0),
                              parameterization=p.get("parameterization", "eps"),
                              cond_stage_key=p.get("cond_stage_key", "caption"))
    device = torch.device(device)
    ldm.to_empty(device=device)
    init_random_(ldm, torch.Generator(device=device).manual_seed(seed))
    ldm = ldm.to(dtype).eval()
    ldm.set_int8_mode(int8)
    ldm.set_conv_modes(fused_conv, conv_impl)
    return ldm
