"""The port's txt2img slice end to end on the CPU against sd_tpu's.

The tiny UNet and f2 KL decoder and a narrow CLIP text tower, with one set of
random weights, go into sd_tpu's LatentDiffusion (assembled directly) and,
through sd_tpu_torch.utils.convert, into the port's. Both pipelines get the
same prompts through the same HashTokenizer and the same x_T, and run PLMS
for 5 steps at guidance 7.5 in fp32. Latents agree to rtol 1e-3 (atol 1e-3
of their scale) and the uint8 images to 1 LSB (the rounding to uint8 may
fall on either side of a .5 boundary).
"""

import os
import subprocess
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from sd_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from sd_tpu.data.tokenizer import HashTokenizer
from sd_tpu.models.clip import CLIPTextConfig as JaxCLIPConfig
from sd_tpu.models.clip import CLIPTextModel as JaxCLIP
from sd_tpu.models.ldm import LatentDiffusion as JaxLDM
from sd_tpu.models.unet import UNetConfig as JaxUNetConfig
from sd_tpu.models.unet import UNetModel as JaxUNet
from sd_tpu.models.vae import AutoencoderKL as JaxKL
from sd_tpu.pipelines.txt2img import Txt2ImgPipeline as JaxPipeline
from sd_tpu.pipelines.txt2img import _to_uint8, latents_to_images
from sd_tpu_torch.models.clip import CLIPTextConfig
from sd_tpu_torch.models.unet import UNetConfig
from sd_tpu_torch.pipelines.txt2img import Txt2ImgPipeline
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.config import build_latent_diffusion, tiny_sd_model_config
from sd_tpu_torch.utils.testing import load_numpy_state_dict, randomize_tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["a painting of a virus monster playing guitar", "a red cube"]


def _tokenizer():
    tok = HashTokenizer(64)
    return lambda texts: tok(texts, context_length=8)


def _jax_ldm(cfg, rng):
    p = cfg["params"]
    unet = JaxUNet(JaxUNetConfig.from_dict(p["unet_config"]["params"]))
    kl_p = p["first_stage_config"]["params"]
    kl = JaxKL(ddconfig=kl_p["ddconfig"], embed_dim=kl_p["embed_dim"])
    clip = JaxCLIP(JaxCLIPConfig(**p["cond_stage_config"]["params"]))
    key = jax.random.PRNGKey(0)
    unet_params = randomize_tree(unet.init(key, jnp.zeros((1, 16, 16, 4)),
                                           jnp.zeros((1,), jnp.int32),
                                           jnp.zeros((1, 8, 32)))["params"], rng)
    kl_params = randomize_tree(kl.init(key, jnp.zeros((1, 32, 32, 3)))["params"], rng)
    clip_params = randomize_tree(clip.init(key, jnp.zeros((1, 8), jnp.int32))["params"], rng)
    schedule = JaxSchedule.create(timesteps=p["timesteps"], linear_start=p["linear_start"],
                                  linear_end=p["linear_end"])
    return JaxLDM(unet=unet, unet_params=unet_params, schedule=schedule,
                  first_stage_model=kl, first_stage_params=kl_params,
                  cond_stage_model=clip, cond_stage_params=clip_params,
                  conditioning_key="crossattn", scale_factor=p["scale_factor"])


def _port_ldm(cfg, jldm):
    p = cfg["params"]
    ldm = build_latent_diffusion(cfg, device="cpu")
    unet_cfg = UNetConfig.from_dict(p["unet_config"]["params"])
    load_numpy_state_dict(ldm.model.diffusion_model,
                          convert.unet_state_dict(jldm.unet_params, unet_cfg))
    ddconfig = p["first_stage_config"]["params"]["ddconfig"]
    load_numpy_state_dict(ldm.first_stage_model,
                          convert.vae_state_dict(jldm.first_stage_params, ddconfig))
    clip_cfg = CLIPTextConfig(**p["cond_stage_config"]["params"])
    load_numpy_state_dict(ldm.cond_stage_model.transformer,
                          convert.clip_text_state_dict(jldm.cond_stage_params, clip_cfg))
    return ldm


def test_tiny_txt2img_matches_sd_tpu():
    cfg = tiny_sd_model_config()
    jldm = _jax_ldm(cfg, np.random.default_rng(0))
    x_T = np.random.default_rng(1).standard_normal((2, 32, 32, 4)).astype(np.float32)
    run = dict(height=64, width=64, steps=5, guidance_scale=7.5)

    jpipe = JaxPipeline(ldm=jldm, tokenizer=_tokenizer(), downsample=2)
    cond = jpipe.encode_prompts(PROMPTS)
    uncond = jpipe.encode_prompts([""] * len(PROMPTS))
    want_z = jax.jit(lambda c, u, x: jpipe.sample_latents(
        c, u, jax.random.PRNGKey(0), x_T=x, **run))(cond, uncond, jnp.asarray(x_T))
    want_img = np.asarray(_to_uint8(latents_to_images(jldm, want_z)))

    pipe = Txt2ImgPipeline(ldm=_port_ldm(cfg, jldm), tokenizer=_tokenizer(), downsample=2)
    got_img = pipe(PROMPTS, x_T=torch.from_numpy(x_T), **run)
    got_z = pipe.last_latents.numpy()

    want_z = np.asarray(want_z)
    np.testing.assert_allclose(got_z, want_z, rtol=1e-3, atol=1e-3 * np.abs(want_z).max())
    assert got_img.shape == want_img.shape == (2, 64, 64, 3) and got_img.dtype == np.uint8
    assert np.abs(got_img.astype(int) - want_img.astype(int)).max() <= 1
    assert want_img.std() > 0


def test_cli_runs_the_tiny_port_without_jax(tmp_path):
    """The port's CLI, in a fresh interpreter, imports neither jax, flax nor
    sd_tpu."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['txt2img', '--tiny', '--plms', '--device', 'cpu', '--ddim_steps', '2',"
        f" '--fixed_code', '--outdir', {str(tmp_path)!r}]\n"
        "runpy.run_module('sd_tpu_torch.scripts.txt2img', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'sd_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert os.listdir(tmp_path / "samples") == ["00000.png"]
