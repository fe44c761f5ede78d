"""The config layer (port of ``sd_tpu/utils/config.py``): configs as plain
dicts, ``merge_configs`` and ``apply_dotlist`` (OmegaConf's multi-base
merge and CLI overrides), the target registry (``register_target``,
``instantiate_from_config``) and ``build_latent_diffusion``, which builds
an LDM from random weights, a reference checkpoint's ``state_dict`` or a
training run.

The registry resolves the reference's module paths and ``sd_tpu``'s to the
port's classes: the UNet, the KL autoencoder, the VQ model (``VQModel`` and
``VQModelInterface``) and ``IdentityFirstStage``, the cond stages
(``FrozenCLIPEmbedder``, ``ClassEmbedder``, ``BERTEmbedder``,
``TransformerEmbedder``, ``SpatialRescaler``, ``HybridConditioner``), the
three LR schedules, ``DataModuleFromConfig`` and the synthetic datasets,
``LPIPSWithDiscriminator`` and ``VQLPIPSWithDiscriminator`` (the
first-stage trainer's keyword arguments: their parameters that
``FIRST_STAGE_LOSS_KEYS`` and ``VQ_FIRST_STAGE_LOSS_KEYS`` name), the LSUN
and ImageNet datasets (``data/lsun.py``, ``data/imagenet.py``) and
``torch.nn.Identity`` (also as a cond stage: the super-resolution model's,
which reads ``LR_image``). ``build_latent_diffusion`` takes every conditioning
key (None, ``concat``, ``crossattn``, ``hybrid``, ``adm``) and the cond
stage sentinels ``__is_first_stage__`` and ``__is_unconditional__``; a
config without ``conditioning_key`` gets ``crossattn``, as in ``sd_tpu``,
or ``concat`` where it sets the reference's ``concat_mode`` (which
``sd_tpu`` does not read).

SD v1's model config lives here as a dict, so the card needs no YAML
parser; a CPU test holds it equal to
``configs/stable-diffusion/v1-inference.yaml``. :func:`load_yaml` reads a
config file as JSON where it is JSON (JSON is YAML, and the port's trainer
writes its ``configs/project.yaml`` so), else through ``yaml``.
:func:`train_config` adds a ``data`` node to either model: synthetic images
with token captions under the model's ``cond_stage_key`` (no dataset is in
the repository). :func:`build_latent_diffusion` makes random weights on the
target device from a seeded ``torch.Generator``, or loads a ``state_dict``.
"""

from __future__ import annotations

import copy
import importlib
import json
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.models.clip import CLIPTextConfig
from sd_tpu_torch.models.encoders import (BERTEmbedder, ClassEmbedder, HybridConditioner,
                                         SpatialRescaler, TransformerEmbedder)
from sd_tpu_torch.models.ldm import FrozenCLIPEmbedder, LatentDiffusion
from sd_tpu_torch.models.unet import UNetConfig, UNetModel
from sd_tpu_torch.models.vae import AutoencoderKL, IdentityFirstStage, VQModel
from sd_tpu_torch.utils.checkpoint import filter_state_dict, load_run_params, run_config_path

__all__ = ["SD_V1_MODEL_CONFIG", "tiny_sd_model_config", "tiny_uncond_model_config",
           "tiny_class_cond_model_config", "tiny_knn_model_config", "tiny_inpaint_model_config",
           "train_config",
           "load_yaml",
           "merge_configs", "apply_dotlist", "register_target", "instantiate_from_config",
           "build_latent_diffusion", "build_latent_diffusion_from_run", "init_random_",
           "REFERENCE_EXTRA_KEYS"]

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


def tiny_uncond_model_config() -> Dict[str, Any]:
    """``sd_tpu.utils.testing.tiny_uncond_model_config`` over the port's tiny
    model: no cond stage, no conditioning key, the legacy attention UNet
    (4 heads)."""
    cfg = tiny_sd_model_config()
    cfg["params"]["cond_stage_config"] = UNCONDITIONAL_SENTINEL
    cfg["params"].pop("conditioning_key")
    cfg["params"]["unet_config"]["params"].update(use_spatial_transformer=False,
                                                  context_dim=None, num_heads=4)
    return cfg


def tiny_class_cond_model_config(n_classes: int = 17) -> Dict[str, Any]:
    """``sd_tpu.utils.testing.tiny_class_cond_model_config`` over the port's
    tiny model: a ``ClassEmbedder`` (its last id the unconditional one) as
    the crossattn cond stage, reading ``class_label``."""
    cfg = tiny_sd_model_config()
    p = cfg["params"]
    p["cond_stage_key"] = "class_label"
    p["cond_stage_config"] = {
        "target": "ldm.modules.encoders.modules.ClassEmbedder",
        "params": {"n_classes": n_classes,
                   "embed_dim": p["unet_config"]["params"]["context_dim"]}}
    return cfg


def tiny_knn_model_config() -> Dict[str, Any]:
    """The tiny crossattn model that ``scripts/knn2img.py --tiny`` samples
    (``sd_tpu.utils.testing.tiny_sd_model_config(context_dim=24)``'s UNet
    and f2 first stage): its context is built by the retrieval pipeline,
    so the cond stage is ``torch.nn.Identity``, as the RDM's is."""
    cfg = tiny_sd_model_config()
    p = cfg["params"]
    p["cond_stage_key"] = "nix"
    p["cond_stage_config"] = {"target": "torch.nn.Identity"}
    p["unet_config"]["params"]["context_dim"] = 24
    return cfg


def tiny_inpaint_model_config() -> Dict[str, Any]:
    """The tiny concat model that ``scripts/inpaint.py --tiny`` builds: the
    first stage as the cond stage, the UNet taking x, the masked image's
    latent and the mask (4 + 4 + 1 channels), legacy attention."""
    cfg = tiny_sd_model_config()
    p = cfg["params"]
    p["conditioning_key"] = "concat"
    p["cond_stage_config"] = FIRST_STAGE_SENTINEL
    p["unet_config"]["params"].update(in_channels=9, use_spatial_transformer=False,
                                      context_dim=None)
    return cfg


def train_config(tiny: bool = False, batch_size: Optional[int] = None) -> Dict[str, Any]:
    """``{"model": ..., "data": ...}`` for training SD v1 (512² images, 77
    token ids under ``txt``, batch 4) or the tiny model (32² images, 8 ids
    under ``caption``, batch 2) on ``SyntheticImages``, with two batches of
    other synthetic images for validation."""
    if tiny:
        model = tiny_sd_model_config()
        images = dict(size=32, length=64, caption_tokens=8, caption_vocab=64)
        batch = 2
    else:
        model = copy.deepcopy(SD_V1_MODEL_CONFIG)
        images = dict(size=512, length=1024, caption_tokens=77, caption_vocab=49408)
        batch = 4
    key = model["params"].get("cond_stage_key", "caption")
    batch = batch_size or batch
    dataset = lambda **kw: {"target": "sd_tpu_torch.data.synthetic.SyntheticImages",
                            "params": dict(images, caption_key=key, **kw)}
    return {"model": model,
            "data": {"params": {"batch_size": batch, "train": dataset(seed=0),
                                "validation": dataset(seed=1, length=2 * batch)}}}


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


def merge_configs(configs: Sequence[Optional[Dict]]) -> Dict:
    """Left-to-right deep merge (later wins), like OmegaConf.merge."""

    def merge(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            out = dict(a)
            for k, v in b.items():
                out[k] = merge(a[k], v) if k in a else v
            return out
        return b

    out: Dict = {}
    for c in configs:
        out = merge(out, c or {})
    return out


def apply_dotlist(cfg: Dict, dotlist: Sequence[str]) -> Dict:
    """A copy of ``cfg`` with ``nested.key=value`` overrides (values parsed
    as YAML)."""
    import yaml

    cfg = copy.deepcopy(cfg)
    for item in dotlist:
        key, _, raw = item.partition("=")
        node = cfg
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = yaml.safe_load(raw)
    return cfg


# ------------------------------------------------------------------ registry

_REGISTRY: Dict[str, Callable[..., Any]] = {}

# sentinels of the reference's cond_stage_config
FIRST_STAGE_SENTINEL = "__is_first_stage__"
UNCONDITIONAL_SENTINEL = "__is_unconditional__"
# the lossconfig parameters the first-stage trainer takes: the KL loss's
# (LPIPSWithDiscriminator) and the VQ loss's (VQLPIPSWithDiscriminator)
FIRST_STAGE_LOSS_KEYS = ("disc_start", "kl_weight", "pixelloss_weight", "perceptual_weight",
                         "disc_num_layers", "disc_in_channels", "disc_factor", "disc_weight",
                         "disc_loss", "logvar_init")
VQ_FIRST_STAGE_LOSS_KEYS = ("disc_start", "codebook_weight", "pixelloss_weight",
                            "perceptual_weight", "disc_num_layers", "disc_in_channels",
                            "disc_factor", "disc_weight", "disc_loss", "pixel_loss")


def register_target(*names: str):
    """Register ``fn(params, **extra)``, which makes the object, under each target name."""

    def deco(fn):
        for n in names:
            _REGISTRY[n] = fn
        return fn

    return deco


def instantiate_from_config(cfg: Dict, **extra) -> Any:
    """Build a ``{"target": ..., "params": {...}}`` node through the registry."""
    if not isinstance(cfg, dict) or "target" not in cfg:
        raise KeyError(f"Expected a config dict with 'target', got: {cfg!r}")
    target = cfg["target"]
    if target not in _REGISTRY:
        raise KeyError(f"Unknown target {target!r}. Register it with "
                       f"sd_tpu_torch.utils.config.register_target.")
    return _REGISTRY[target](dict(cfg.get("params") or {}), **extra)


def _register_builtins() -> None:
    from sd_tpu_torch.data import synthetic
    from sd_tpu_torch.training import lr_schedules

    register_target("ldm.modules.diffusionmodules.openaimodel.UNetModel",
                    "sd_tpu.models.unet.UNetModel")(
        lambda p: UNetModel(UNetConfig.from_dict(p)))
    register_target("ldm.models.autoencoder.AutoencoderKL", "sd_tpu.models.vae.AutoencoderKL")(
        lambda p: AutoencoderKL(p["ddconfig"], p["embed_dim"]))
    register_target("ldm.models.autoencoder.VQModel", "ldm.models.autoencoder.VQModelInterface",
                    "sd_tpu.models.vae.VQModel")(
        lambda p: VQModel(p["ddconfig"], p["n_embed"], p["embed_dim"]))
    register_target("ldm.models.autoencoder.IdentityFirstStage",
                    "sd_tpu.models.vae.IdentityFirstStage")(lambda p: IdentityFirstStage())
    register_target("ldm.modules.encoders.modules.FrozenCLIPEmbedder",
                    "sd_tpu.models.clip.CLIPTextModel")(
        lambda p: FrozenCLIPEmbedder(CLIPTextConfig(**p)))
    register_target("ldm.modules.encoders.modules.ClassEmbedder",
                    "sd_tpu.models.encoders.ClassEmbedder")(
        lambda p: ClassEmbedder(p["embed_dim"], p.get("n_classes", 1000)))
    register_target("ldm.modules.encoders.modules.BERTEmbedder",
                    "sd_tpu.models.encoders.BERTEmbedder")(
        lambda p: BERTEmbedder(p["n_embed"], p["n_layer"], p.get("vocab_size", 30522),
                               p.get("max_seq_len", 77)))
    register_target("ldm.modules.encoders.modules.TransformerEmbedder",
                    "sd_tpu.models.encoders.TransformerEmbedder")(
        lambda p: TransformerEmbedder(p["n_embed"], p["n_layer"], p.get("vocab_size", 30522),
                                      p.get("max_seq_len", 77)))
    register_target("ldm.modules.encoders.modules.SpatialRescaler",
                    "sd_tpu.models.encoders.SpatialRescaler")(lambda p: SpatialRescaler(**p))
    register_target("ldm.modules.diffusionmodules.util.HybridConditioner",
                    "sd_tpu.models.encoders.HybridConditioner")(
        lambda p: HybridConditioner(instantiate_from_config(p["c_concat_config"]),
                                    instantiate_from_config(p["c_crossattn_config"])))
    register_target("ldm.lr_scheduler.LambdaLinearScheduler",
                    "sd_tpu.training.lr_schedules.lambda_linear")(
        lambda p: lr_schedules.lambda_linear(p["warm_up_steps"], p["f_min"], p["f_max"],
                                             p["f_start"], p["cycle_lengths"]))
    register_target("ldm.lr_scheduler.LambdaWarmUpCosineScheduler2",
                    "sd_tpu.training.lr_schedules.lambda_warmup_cosine2")(
        lambda p: lr_schedules.lambda_warmup_cosine2(p["warm_up_steps"], p["f_min"],
                                                     p["f_max"], p["f_start"],
                                                     p["cycle_lengths"]))
    register_target("ldm.lr_scheduler.LambdaWarmUpCosineScheduler",
                    "sd_tpu.training.lr_schedules.lambda_warmup_cosine")(
        lambda p: lr_schedules.lambda_warmup_cosine(p["warm_up_steps"], p["lr_min"],
                                                    p["lr_max"], p["lr_start"],
                                                    p["max_decay_steps"]))

    @register_target("sd_tpu.training.trainer.DataModuleFromConfig", "main.DataModuleFromConfig",
                     "sd_tpu_torch.training.trainer.DataModuleFromConfig")
    def _datamodule(p):
        from sd_tpu_torch.training.trainer import DataModuleFromConfig

        return DataModuleFromConfig(**p)

    for name in ("SyntheticImages", "ColoredShapes"):
        register_target(f"sd_tpu.data.synthetic.{name}", f"sd_tpu_torch.data.synthetic.{name}")(
            lambda p, _cls=getattr(synthetic, name): _cls(**p))
    register_target("ldm.modules.losses.LPIPSWithDiscriminator",
                    "ldm.modules.losses.contperceptual.LPIPSWithDiscriminator")(
        lambda p: {k: v for k, v in p.items() if k in FIRST_STAGE_LOSS_KEYS})
    register_target("torch.nn.Identity")(lambda p: nn.Identity())

    @register_target("ldm.models.diffusion.ddpm.LatentDiffusion",
                     "sd_tpu.models.ldm.LatentDiffusion")
    def _ldm(p, **extra):
        return build_latent_diffusion(
            {"target": "ldm.models.diffusion.ddpm.LatentDiffusion", "params": p}, **extra)

    register_target("taming.modules.losses.vqperceptual.VQLPIPSWithDiscriminator",
                    "ldm.modules.losses.vqperceptual.VQLPIPSWithDiscriminator")(
        lambda p: {k: v for k, v in p.items() if k in VQ_FIRST_STAGE_LOSS_KEYS})

    def dataset(module: str, name: str):
        def build(p):
            mod = importlib.import_module(f"sd_tpu_torch.data.{module}")
            return getattr(mod, name)(**p)

        register_target(f"ldm.data.{module}.{name}", f"sd_tpu_torch.data.{module}.{name}")(build)

    for name in ("LSUNChurchesTrain", "LSUNChurchesValidation", "LSUNBedroomsTrain",
                 "LSUNBedroomsValidation", "LSUNCatsTrain", "LSUNCatsValidation"):
        dataset("lsun", name)
    for name in ("ImageNetTrain", "ImageNetValidation", "ImageNetSRTrain",
                 "ImageNetSRValidation"):
        dataset("imagenet", name)


# what a reference LatentDiffusion checkpoint holds beside the modules'
# weights: the schedule buffers (the port computes its schedule from the
# config), the EMA shadow, and HF CLIP's position ids
REFERENCE_EXTRA_KEYS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
    "model_ema.", "cond_stage_model.transformer.text_model.embeddings.position_ids")


def load_yaml(path: str) -> Dict[str, Any]:
    """A config file: parsed as JSON where it is JSON, else as YAML."""
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        import yaml

        return yaml.safe_load(text)


def build_latent_diffusion(model_cfg: Dict[str, Any], *, device, dtype=torch.float32,
                           seed: int = 0, int8="off", fused_conv=None, conv_impl=None,
                           state_dict: Optional[Mapping[str, torch.Tensor]] = None
                           ) -> LatentDiffusion:
    """Build a :class:`LatentDiffusion` from a config's ``model`` node on
    ``device`` (``meta`` for the shapes alone) in ``dtype``, with random weights from
    ``torch.Generator(device).manual_seed(seed)``, or, given ``state_dict``
    (a reference checkpoint's) or a ``params.ckpt_path`` in the config (the
    reference's warm start: that file's), its weights: loaded strictly once
    :data:`REFERENCE_EXTRA_KEYS` are dropped, then cast to ``dtype``. The
    int8 serving mode ``int8`` (``SD_TPU_INT8``'s grammar; off by default)
    is held on its sites, with the weights it reads quantized after the
    cast (``sd_tpu``'s ``maybe_weight_quant_overlay``), and the conv modes
    ``fused_conv`` and ``conv_impl`` (``SD_TPU_FUSED_CONV``'s and
    ``SD_TPU_CONV_IMPL``'s values; None reads the variable, here, once).
    With ``__is_first_stage__`` the cond stage is the first stage's module,
    so a ``state_dict`` holds its weights under both names, as the
    reference's checkpoints do."""
    p = copy.deepcopy(model_cfg.get("params") or {})
    cond_cfg = p.get("cond_stage_config")
    unconditional = cond_cfg in (None, UNCONDITIONAL_SENTINEL)
    key = None if unconditional else (
        p.get("conditioning_key") or ("concat" if p.get("concat_mode") else "crossattn"))
    schedule = DiffusionSchedule.create(
        timesteps=p.get("timesteps", 1000), beta_schedule=p.get("beta_schedule", "linear"),
        linear_start=p.get("linear_start", 1e-4), linear_end=p.get("linear_end", 2e-2),
        cosine_s=p.get("cosine_s", 8e-3), v_posterior=p.get("v_posterior", 0.0),
        parameterization=p.get("parameterization", "eps"))
    with torch.device("meta"):
        first_stage = instantiate_from_config(p["first_stage_config"])
        cond_stage = (None if unconditional else first_stage
                      if cond_cfg == FIRST_STAGE_SENTINEL else instantiate_from_config(cond_cfg))
        ldm = LatentDiffusion(instantiate_from_config(p["unet_config"]), first_stage,
                              cond_stage, schedule, scale_factor=p.get("scale_factor", 1.0),
                              parameterization=p.get("parameterization", "eps"),
                              cond_stage_key=p.get("cond_stage_key", "caption"),
                              conditioning_key=key)
    device = torch.device(device)
    ldm.to_empty(device=device)
    if state_dict is None and p.get("ckpt_path") and device.type != "meta":
        from sd_tpu_torch.utils.port import load_torch_state_dict

        state_dict = load_torch_state_dict(p["ckpt_path"])
    if state_dict is None:
        if device.type != "meta":  # the meta device holds shapes only
            init_random_(ldm, torch.Generator(device=device).manual_seed(seed))
    else:
        ldm.load_state_dict(filter_state_dict(dict(state_dict), REFERENCE_EXTRA_KEYS))
    ldm = ldm.to(dtype).eval()
    ldm.set_int8_mode(int8)
    ldm.set_conv_modes(fused_conv, conv_impl)
    return ldm


def build_latent_diffusion_from_run(run_path: str, config_path: Optional[str] = None, *,
                                    device, dtype=torch.float32, use_ema: bool = True,
                                    int8="off", fused_conv=None, conv_impl=None
                                    ) -> Tuple[LatentDiffusion, Dict[str, Any]]:
    """Build an inference model from one of the port's training runs.

    The run's checkpoint gives the UNet (the EMA shadow by default, the
    current parameters with ``use_ema=False``) and the ``scale_factor``;
    the frozen stages, which the checkpoint does not hold, are drawn again
    from the run's config (``<logdir>/configs/project.yaml``, or
    ``config_path``) and its recorded seed, on the device type they were
    drawn on: a torch generator draws other numbers on another device type,
    so a build on another one is refused. A run warm-started from a
    reference checkpoint (``model.params.ckpt_path`` in its config) takes
    them from that file instead, on any device. Returns ``(ldm, meta)``; anything
    unresolvable raises, so a run directory never samples random weights.
    """
    params, meta = load_run_params(run_path, use_ema=use_ema)
    config_path = config_path or run_config_path(run_path)
    if config_path is None:
        raise FileNotFoundError(f"no model config for run {run_path!r}: the logdir has no "
                                f"configs/project.yaml; pass the config explicitly")
    cfg = load_yaml(config_path)
    model_cfg = cfg["model"] if "model" in cfg else cfg
    device = torch.device(device)
    drawn_on = meta.get("frozen_device")
    warm_started = bool((model_cfg.get("params") or {}).get("ckpt_path"))
    if not warm_started and drawn_on is not None and drawn_on != device.type:
        raise ValueError(f"run {run_path!r} drew its frozen stages on {drawn_on}; rebuilding "
                         f"them on {device.type} would draw other weights")
    ldm = build_latent_diffusion(model_cfg, device=device, dtype=dtype, seed=int(meta["seed"]),
                                 fused_conv=fused_conv, conv_impl=conv_impl)
    ldm.model.diffusion_model.load_state_dict(params["unet"])
    if "cond_stage" in params:  # a run that trained its cond stage
        ldm.cond_stage_model.load_state_dict(params["cond_stage"])
    if meta.get("scale_factor") is not None:
        ldm.scale_factor = float(meta["scale_factor"])
    ldm.set_int8_mode(int8)
    print(f"Restored {meta['params_source']} params from run {run_path} "
          f"(step {meta.get('step')}, scale_factor={ldm.scale_factor})", flush=True)
    return ldm, meta


_register_builtins()
