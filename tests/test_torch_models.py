"""The port's models against sd_tpu's on the CPU in fp32, with the same
weights (sd_tpu params → sd_tpu_torch.utils.convert → load_state_dict) and
the same numpy inputs. Tolerance rtol 1e-4, atol 1e-4 of the output's scale.

Also: the converter is the exact inverse of sd_tpu's torch porters, the full
SD v1 UNet has sd_tpu's parameter count, and the port's SD v1 config dict is
the shipped YAML.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.models import clip as jclip
from sd_tpu.models import unet as junet
from sd_tpu.models import vae as jvae
from sd_tpu.utils import port
from sd_tpu.utils.config import load_yaml
from sd_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from sd_tpu_torch.models.unet import UNetConfig, UNetModel
from sd_tpu_torch.models.vae import AutoencoderKL
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.config import (
    SD_V1_MODEL_CONFIG,
    build_latent_diffusion,
    tiny_sd_model_config,
)
from sd_tpu_torch.utils.testing import load_numpy_state_dict, random_state_dict, randomize_tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TINY = tiny_sd_model_config()["params"]
UNET_P = _TINY["unet_config"]["params"]
DDCONFIG = dict(_TINY["first_stage_config"]["params"]["ddconfig"], attn_resolutions=[16])
CLIP_P = _TINY["cond_stage_config"]["params"]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _init(module, seed, *args, **kw):
    variables = module.init(jax.random.PRNGKey(0), *args, **kw)
    return randomize_tree(variables["params"], np.random.default_rng(seed))


def test_unet_matches_sd_tpu():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([981, 21], np.int32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    jmodel = junet.UNetModel(junet.UNetConfig.from_dict(UNET_P))
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    params = _init(jmodel, 1, *args)
    want = jmodel.apply({"params": params}, *args)
    cfg = UNetConfig.from_dict(UNET_P)
    unet = load_numpy_state_dict(UNetModel(cfg), convert.unet_state_dict(params, cfg))
    with torch.no_grad():
        got = unet(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(t),
                   torch.from_numpy(ctx))
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_vae_decoder_matches_sd_tpu():
    """The tiny f2 decoder with attention in its 16x16 up level, plus the
    mid-block attention, and post_quant_conv."""
    z = np.random.default_rng(2).standard_normal((1, 16, 16, 4)).astype(np.float32)
    jmodel = jvae.AutoencoderKL(ddconfig=DDCONFIG, embed_dim=4)
    params = _init(jmodel, 3, jnp.zeros((1, 32, 32, 3)))
    want = jmodel.apply({"params": params}, jnp.asarray(z), method=jmodel.decode)
    ae = load_numpy_state_dict(AutoencoderKL(DDCONFIG, 4),
                               convert.vae_state_dict(params, DDCONFIG))
    with torch.no_grad():
        got = ae.decode(torch.from_numpy(z.transpose(0, 3, 1, 2).copy()))
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_clip_text_matches_sd_tpu():
    ids = np.array([[62, 5, 17, 63, 63, 63, 63, 63], [62, 40, 63, 63, 63, 63, 63, 63]],
                   np.int32)
    jcfg = jclip.CLIPTextConfig(**CLIP_P)
    jmodel = jclip.CLIPTextModel(jcfg)
    params = _init(jmodel, 4, jnp.asarray(ids))
    want = jmodel.apply({"params": params}, jnp.asarray(ids))
    cfg = CLIPTextConfig(**CLIP_P)
    model = load_numpy_state_dict(CLIPTextModel(cfg), convert.clip_text_state_dict(params, cfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    for key in ("last_hidden_state", "pooler_output"):
        _close(got[key].numpy(), want[key])


def _round_trip(which):
    """A random reference-layout state_dict → sd_tpu's porter → convert."""
    rng = np.random.default_rng(5)
    if which == "unet":
        cfg = UNetConfig.from_dict(UNET_P)
        sd = random_state_dict(UNetModel(cfg), rng)
        params = junet.port_unet(sd, junet.UNetConfig.from_dict(UNET_P), prefix="")
        return sd, convert.unet_state_dict(params, cfg)
    if which in ("decoder", "encoder"):
        # one half of the autoencoder's state_dict, through that half's porter
        sd = random_state_dict(AutoencoderKL(DDCONFIG, 4), rng)
        conv = "post_quant_conv" if which == "decoder" else "quant_conv"
        sd = {k: v for k, v in sd.items() if k.startswith((which + ".", conv + "."))}
        porter = jvae.port_decoder if which == "decoder" else jvae.port_encoder
        params = {which: porter(sd, DDCONFIG, prefix=which),
                  conv: port.dense_from_conv1x1(sd, conv)}
        to_port = (convert.vae_decoder_state_dict if which == "decoder"
                   else convert.vae_encoder_state_dict)
        return sd, to_port(params, DDCONFIG)
    cfg = CLIPTextConfig(**CLIP_P)
    sd = random_state_dict(CLIPTextModel(cfg), rng)
    params = jclip.port_clip_text(sd, jclip.CLIPTextConfig(**CLIP_P), prefix="text_model.")
    return sd, convert.clip_text_state_dict(params, cfg)


@pytest.mark.parametrize("which", ["unet", "decoder", "encoder", "clip"])
def test_converter_inverts_the_porters(which):
    sd, back = _round_trip(which)
    assert sorted(back) == sorted(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_sd_v1_unet_parameter_count():
    """Full width: the port's UNet on the meta device against sd_tpu's
    jax.eval_shape of init (no memory, no compute)."""
    unet_p = SD_V1_MODEL_CONFIG["params"]["unet_config"]["params"]
    with torch.device("meta"):
        unet = UNetModel(UNetConfig.from_dict(unet_p))
    n_port = sum(p.numel() for p in unet.parameters())
    jmodel = junet.UNetModel(junet.UNetConfig.from_dict(unet_p))
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 77, 768))))
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes["params"]))
    assert n_port == n_jax
    assert 859e6 < n_port < 860e6


def test_sd_v1_config_is_the_yaml():
    yaml_cfg = load_yaml(os.path.join(_REPO, "configs/stable-diffusion/v1-inference.yaml"))
    assert SD_V1_MODEL_CONFIG == yaml_cfg["model"]


def test_ldm_state_dict_uses_checkpoint_names():
    ldm = build_latent_diffusion(tiny_sd_model_config(), device="cpu")
    prefixes = {k.split(".")[0] + "." + k.split(".")[1] for k in ldm.state_dict()}
    assert prefixes == {"model.diffusion_model", "first_stage_model.encoder",
                        "first_stage_model.quant_conv", "first_stage_model.decoder",
                        "first_stage_model.post_quant_conv", "cond_stage_model.transformer"}
    assert all(p.abs().sum() > 0 for p in ldm.parameters())
