"""Shared pieces of the port's parity tests against sd_tpu (not a test
module): layout helpers, and the tiny model's sd_tpu parameters made with
numpy from a seed over shapes that ``jax.eval_shape`` reads off the flax
modules (initialising them would cost tens of seconds on the CPU)."""

import contextlib

import numpy as np
import torch

import jax
import jax.numpy as jnp

from sd_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from sd_tpu.models.clip import CLIPTextConfig as JaxCLIPConfig
from sd_tpu.models.clip import CLIPTextModel as JaxCLIP
from sd_tpu.models.ldm import LatentDiffusion as JaxLDM
from sd_tpu.models.unet import UNetConfig as JaxUNetConfig
from sd_tpu.models.unet import UNetModel as JaxUNet
from sd_tpu.models.vae import AutoencoderKL as JaxKL
from sd_tpu_torch.models.clip import CLIPTextConfig
from sd_tpu_torch.models.unet import UNetConfig
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.testing import randomize_tree


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def random_params(module, rng: np.random.Generator, *args):
    """``randomize_tree`` over the parameter shapes of ``module.init(*args)``."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args)["params"])
    return randomize_tree(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes), rng)


def tiny_jax_ldm(cfg, rng: np.random.Generator) -> JaxLDM:
    """sd_tpu's LatentDiffusion for the port's tiny config (its narrow CLIP
    text tower included), assembled directly, with random parameters."""
    p = cfg["params"]
    unet = JaxUNet(JaxUNetConfig.from_dict(p["unet_config"]["params"]))
    kl_p = p["first_stage_config"]["params"]
    kl = JaxKL(ddconfig=kl_p["ddconfig"], embed_dim=kl_p["embed_dim"])
    clip = JaxCLIP(JaxCLIPConfig(**p["cond_stage_config"]["params"]))
    schedule = JaxSchedule.create(timesteps=p["timesteps"], linear_start=p["linear_start"],
                                  linear_end=p["linear_end"])
    return JaxLDM(
        unet=unet, schedule=schedule, first_stage_model=kl, cond_stage_model=clip,
        unet_params=random_params(unet, rng, jnp.zeros((1, 16, 16, 4)),
                                  jnp.zeros((1,), jnp.int32), jnp.zeros((1, 8, 32))),
        first_stage_params=random_params(kl, rng, jnp.zeros((1, 32, 32, 3))),
        cond_stage_params=random_params(clip, rng, jnp.zeros((1, 8), jnp.int32)),
        conditioning_key="crossattn", scale_factor=p["scale_factor"])


def jax_ldm(cfg, rng: np.random.Generator) -> JaxLDM:
    """sd_tpu's LatentDiffusion for a port config whose cond stage is a
    sentinel (``__is_first_stage__``, ``__is_unconditional__``), a
    ``ClassEmbedder`` or ``torch.nn.Identity``: the stages from sd_tpu's
    registry, random parameters over ``jax.eval_shape`` shapes, the
    conditioning key by sd_tpu's rule."""
    from sd_tpu.utils import config as jconfig

    p = cfg["params"]
    unet = jconfig.instantiate_from_config(p["unet_config"])
    ucfg = unet.config
    hw = p.get("image_size", ucfg.image_size)
    args = [jnp.zeros((1, hw, hw, ucfg.in_channels)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 8, ucfg.context_dim)) if ucfg.context_dim else None,
            jnp.zeros((1,), jnp.int32) if ucfg.num_classes else None]
    first = jconfig.instantiate_from_config(p["first_stage_config"])
    res = first.ddconfig["resolution"]
    first_params = random_params(first, rng, jnp.zeros((1, res, res, 3)))
    cond_cfg = p.get("cond_stage_config")
    key = p.get("conditioning_key") or "crossattn"
    cond = cond_params = None
    if cond_cfg == "__is_first_stage__":
        cond, cond_params = first, first_params
    elif isinstance(cond_cfg, dict) and cond_cfg["target"] == "torch.nn.Identity":
        cond = jconfig.instantiate_from_config(cond_cfg)
    elif isinstance(cond_cfg, dict):
        cond = jconfig.instantiate_from_config(cond_cfg)
        cond_params = random_params(cond, rng, jnp.zeros((1,), jnp.int32))
    else:
        key = None
    schedule = JaxSchedule.create(timesteps=p["timesteps"], linear_start=p["linear_start"],
                                  linear_end=p["linear_end"])
    return JaxLDM(unet=unet, unet_params=random_params(unet, rng, *args), schedule=schedule,
                  first_stage_model=first, first_stage_params=first_params,
                  cond_stage_model=cond, cond_stage_params=cond_params, conditioning_key=key,
                  scale_factor=p.get("scale_factor", 1.0))


def ldm_state_dict(cfg, jldm: JaxLDM) -> dict:
    """The reference checkpoint's model keys for ``jldm``'s parameters
    (numpy): ``model.diffusion_model.*``, ``first_stage_model.*`` (the KL or
    the VQ autoencoder) and the cond stage's: CLIP's
    ``cond_stage_model.transformer.text_model.*``, a ClassEmbedder's, the
    first stage's again under ``cond_stage_model.``, or none (an
    unconditional model, ``torch.nn.Identity``)."""
    p = cfg["params"]
    first = (convert.vq_state_dict if "quantize" in jldm.first_stage_params
             else convert.vae_state_dict)
    parts = {
        "model.diffusion_model.": convert.unet_state_dict(
            jldm.unet_params, UNetConfig.from_dict(p["unet_config"]["params"])),
        "first_stage_model.": first(
            jldm.first_stage_params, p["first_stage_config"]["params"]["ddconfig"]),
    }
    cond_cfg = p.get("cond_stage_config")
    if cond_cfg == "__is_first_stage__":
        parts["cond_stage_model."] = parts["first_stage_model."]
    elif isinstance(cond_cfg, dict) and cond_cfg["target"] == "torch.nn.Identity":
        pass
    elif isinstance(cond_cfg, dict) and cond_cfg["target"].endswith("ClassEmbedder"):
        parts["cond_stage_model."] = convert.class_embedder_state_dict(jldm.cond_stage_params)
    elif isinstance(cond_cfg, dict):
        parts["cond_stage_model.transformer."] = convert.clip_text_state_dict(
            jldm.cond_stage_params, CLIPTextConfig(**cond_cfg["params"]))
    return {prefix + k: v for prefix, sd in parts.items() for k, v in sd.items()}


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to ``n`` within the block. The test
    command runs six pytest workers on the machine's cores, and a worker's
    default of one thread per core oversubscribes them: a file whose torch
    work runs in seconds alone took minutes there."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
