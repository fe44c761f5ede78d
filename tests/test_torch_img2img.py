"""The port's img2img against sd_tpu's on the CPU in fp32.

The tiny model's weights go into both packages (tests/torch_parity.py), the
same init image (a seeded gradient with noise, 40x50, cropped to 32x32) and
prompts into both pipelines, and sd_tpu's own draws into the port: the test
splits the key as sd_tpu's Img2ImgPipeline does (``split(rng, 4)``: the
posterior's noise from the second key, the stochastic encode's from the
third) and hands both to the port as ``noise``. At strength 0, 0.5 and 1
with DDIM 4 and guidance 7.5, the [0, 1] images agree within 1e-4 (fp32
through the VAE twice and the tiny UNet), and the uint8 images differ by at
most 1 at under 0.1% of the pixels (the rounding to uint8 may fall on
either side of a .5 boundary).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.data.tokenizer import HashTokenizer
from sd_tpu.pipelines.img2img import Img2ImgPipeline as JaxImg2Img
from sd_tpu.pipelines.img2img import preprocess_image as jax_preprocess_image
from sd_tpu.pipelines.img2img import preprocess_mask as jax_preprocess_mask
from sd_tpu.pipelines.txt2img import Txt2ImgPipeline as JaxTxt2Img
from sd_tpu_torch.pipelines.img2img import Img2ImgPipeline, preprocess_image, preprocess_mask
from sd_tpu_torch.pipelines.txt2img import Txt2ImgPipeline
from sd_tpu_torch.utils.config import build_latent_diffusion, tiny_sd_model_config
from sd_tpu_torch.utils.testing import load_numpy_state_dict
from torch_parity import ldm_state_dict, tiny_jax_ldm, torch_threads

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


PROMPTS = ["a fantasy landscape", "a red cube"]
STEPS = 4


def _tokenizer():
    tok = HashTokenizer(64)
    return lambda texts: tok(texts, context_length=8)


def init_image(h=40, w=50, seed=0):
    """A seeded horizontal and vertical gradient with noise, uint8."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([255 * xx / w, 255 * yy / h, 128 + 0 * xx], -1)
    img = img + rng.normal(0, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def test_preprocess_matches_sd_tpu():
    for img in (init_image(), init_image(96, 64, 1).astype(np.float32) / 255.0):
        got, want = preprocess_image(img), jax_preprocess_image(img)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    mask = (np.random.default_rng(2).uniform(size=(64, 48)) > 0.9).astype(np.uint8)
    for m, f in ((mask, 8), (np.stack([mask] * 3, -1), 4)):
        np.testing.assert_array_equal(preprocess_mask(m, f), jax_preprocess_mask(m, f))
    assert preprocess_mask(mask).shape == (1, 8, 6, 1)


@pytest.fixture(scope="module")
def pipelines():
    cfg = tiny_sd_model_config()
    jldm = tiny_jax_ldm(cfg, np.random.default_rng(0))
    ldm = load_numpy_state_dict(build_latent_diffusion(cfg, device="cpu"),
                                ldm_state_dict(cfg, jldm))
    jpipe = JaxImg2Img(JaxTxt2Img(ldm=jldm, tokenizer=_tokenizer(), downsample=2))
    pipe = Img2ImgPipeline(Txt2ImgPipeline(ldm=ldm, tokenizer=_tokenizer(), downsample=2))
    return jldm, jpipe, pipe


@pytest.mark.parametrize("strength", [0.0, 0.5, 1.0])
def test_tiny_img2img_matches_sd_tpu(pipelines, strength):
    jldm, jpipe, pipe = pipelines
    img, rng = init_image(), jax.random.PRNGKey(3)
    want_u8 = jpipe(img, PROMPTS, rng, strength=strength, steps=STEPS, guidance_scale=7.5)
    # sd_tpu's [0, 1] images: its compiled program, called again on the same inputs
    _, k_enc, k_noise, k_dec = jax.random.split(rng, 4)
    t_enc = int(strength * STEPS)
    program = jpipe._jit_cache[("img2img", STEPS, t_enc, 7.5)]
    x = jnp.tile(jnp.asarray(jax_preprocess_image(img)), (2, 1, 1, 1))
    base = jpipe.base
    want01 = np.asarray(program(jldm.runtime_params(), x, base.encode_prompts(PROMPTS),
                                base.encode_prompts([""] * 2), k_enc, k_noise, k_dec))

    shape = (2, 16, 16, 4)
    draws = [torch.from_numpy(np.array(jax.random.normal(k, shape))) for k in (k_enc, k_noise)]
    got_u8 = pipe(img, PROMPTS, strength=strength, steps=STEPS, guidance_scale=7.5,
                  noise=draws)
    with torch.no_grad():
        x01 = pipe.base.ldm.decode_first_stage(pipe.last_latents.permute(0, 3, 1, 2))
    got01 = torch.clamp((x01 + 1.0) / 2.0, 0.0, 1.0).permute(0, 2, 3, 1).numpy()

    assert got01.shape == want01.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got01, want01, rtol=0, atol=1e-4)
    assert got_u8.shape == want_u8.shape and got_u8.dtype == want_u8.dtype == np.uint8
    diff = np.abs(got_u8.astype(int) - want_u8.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert not np.array_equal(got_u8[0], got_u8[1])  # each copy has its own draws
    assert set(pipe.last_timings) == {"encode_s", "sample_s", "decode_s", "total_s"}


def test_img2img_refuses_a_strength_outside_0_1(pipelines):
    with pytest.raises(ValueError, match="strength"):
        pipelines[2](init_image(), PROMPTS, strength=1.5, steps=STEPS)


def test_img2img_cli_writes_its_samples(tmp_path):
    from PIL import Image

    from sd_tpu_torch.scripts.img2img import main

    Image.fromarray(init_image()).save(tmp_path / "init.png")
    out = tmp_path / "out"
    main(["--init-img", str(tmp_path / "init.png"), "--tiny", "--device", "cpu",
          "--ddim_steps", "3", "--n_samples", "2", "--n_iter", "2", "--outdir", str(out)])
    names = sorted(p.name for p in out.iterdir())
    assert names == ["00000.png", "00001.png", "00002.png", "00003.png"]
    first = np.asarray(Image.open(out / "00000.png"))
    assert first.shape == (32, 32, 3) and first.std() > 0
