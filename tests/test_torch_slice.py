"""The port's txt2img slice end to end on the CPU against sd_tpu's.

The tiny UNet and f2 KL decoder and a narrow CLIP text tower, with one set of
random weights, go into sd_tpu's LatentDiffusion (assembled directly) and,
through sd_tpu_torch.utils.convert, into the port's. Both pipelines get the
same prompts through the same HashTokenizer and the same x_T, and run PLMS
for 5 steps at guidance 7.5 in fp32 (then DDIM with negative prompts, and
DPM-Solver++). Latents agree to rtol 1e-3 (atol 1e-3 of their scale) and
the uint8 images to 1 LSB (the rounding to uint8 may fall on either side of
a .5 boundary). ``map_batches`` gives the images of sequential calls, and
the CLI writes its samples and grid with each sampler. The two models and
sd_tpu's decode (one jitted program for every test's latents) are built
once for the module.
"""

import os
import subprocess
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp
import pytest

from sd_tpu.data.tokenizer import HashTokenizer
from sd_tpu.pipelines.txt2img import Txt2ImgPipeline as JaxPipeline
from sd_tpu.pipelines.txt2img import _to_uint8, latents_to_images
from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
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


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPTS = ["a painting of a virus monster playing guitar", "a red cube"]


def _tokenizer():
    tok = HashTokenizer(64)
    return lambda texts: tok(texts, context_length=8)


def _port_ldm(cfg, jldm):
    return load_numpy_state_dict(build_latent_diffusion(cfg, device="cpu"),
                                 ldm_state_dict(cfg, jldm))


@pytest.fixture(scope="module")
def models():
    """The tiny config, sd_tpu's LDM with random weights, the port's with the
    same, and sd_tpu's latents-to-uint8 decode, compiled once."""
    cfg = tiny_sd_model_config()
    jldm = tiny_jax_ldm(cfg, np.random.default_rng(0))
    decode = jax.jit(lambda z: _to_uint8(latents_to_images(jldm, z)))
    return cfg, jldm, _port_ldm(cfg, jldm), decode


def test_tiny_txt2img_matches_sd_tpu(models):
    cfg, jldm, port, decode = models
    x_T = np.random.default_rng(1).standard_normal((2, 32, 32, 4)).astype(np.float32)
    run = dict(height=64, width=64, steps=5, guidance_scale=7.5)

    jpipe = JaxPipeline(ldm=jldm, tokenizer=_tokenizer(), downsample=2)
    cond = jpipe.encode_prompts(PROMPTS)
    uncond = jpipe.encode_prompts([""] * len(PROMPTS))
    want_z = jax.jit(lambda c, u, x: jpipe.sample_latents(
        c, u, jax.random.PRNGKey(0), x_T=x, **run))(cond, uncond, jnp.asarray(x_T))
    want_img = np.asarray(decode(want_z))

    pipe = Txt2ImgPipeline(ldm=port, tokenizer=_tokenizer(), downsample=2)
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


@pytest.mark.parametrize("sampler,negative", [("ddim", ["blurry", "low quality"]),
                                              ("dpm", None)])
def test_tiny_pipeline_samplers_match_sd_tpu(models, sampler, negative):
    cfg, jldm, port, decode = models
    x_T = np.random.default_rng(2).standard_normal((2, 32, 32, 4)).astype(np.float32)
    run = dict(height=64, width=64, steps=4, guidance_scale=7.5, sampler=sampler)
    jpipe = JaxPipeline(ldm=jldm, tokenizer=_tokenizer(), downsample=2)
    want_z = jax.jit(lambda c, u, x: jpipe.sample_latents(
        c, u, jax.random.PRNGKey(0), x_T=x, **run))(
        jpipe.encode_prompts(PROMPTS), jpipe.encode_prompts(negative or [""] * 2),
        jnp.asarray(x_T))
    want_img = np.asarray(decode(want_z))
    pipe = Txt2ImgPipeline(ldm=port, tokenizer=_tokenizer(), downsample=2)
    got_img = pipe(PROMPTS, x_T=torch.from_numpy(x_T), negative_prompts=negative, **run)
    want_z = np.asarray(want_z)
    np.testing.assert_allclose(pipe.last_latents.numpy(), want_z, rtol=1e-3,
                               atol=1e-3 * np.abs(want_z).max())
    assert np.abs(got_img.astype(int) - want_img.astype(int)).max() <= 1


def test_map_batches_gives_the_images_of_sequential_calls():
    pipe, hw = build_txt2img_pipeline(tiny=True, device="cpu", seed=0)
    requests = lambda: [dict(prompts=[PROMPTS[r % 2]] * (r + 1),
                             generator=torch.Generator().manual_seed(r), height=hw, width=hw,
                             steps=3, sampler="ddim", eta=1.0) for r in range(3)]
    sequential = []
    for req in requests():
        sequential.append(pipe(**req))
        assert set(pipe.last_timings) == {"encode_s", "sample_s", "decode_s", "safety_s",
                                          "total_s"}
    for got, want in zip(pipe.map_batches(requests(), depth=2), sequential, strict=True):
        np.testing.assert_array_equal(got, want)
        assert pipe.last_safety_flags == [False] * len(want)


@pytest.mark.parametrize("flags", [[], ["--dpm_solver"], ["--n_iter", "2", "--from-file"]])
def test_cli_samplers_write_samples_and_grid(tmp_path, flags):
    from sd_tpu_torch.scripts.txt2img import main

    if "--from-file" in flags:
        (tmp_path / "prompts.txt").write_text("a red cube\n\na blue ball\n")
        flags = flags + [str(tmp_path / "prompts.txt")]
    out = tmp_path / "out"
    main(["--tiny", "--device", "cpu", "--ddim_steps", "2", "--outdir", str(out)] + flags)
    n = 4 if "--n_iter" in flags else 1
    assert sorted(os.listdir(out / "samples")) == [f"{i:05}.png" for i in range(n)]
    assert (out / "grid-0000.png").is_file()
