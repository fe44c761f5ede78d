"""The port's inpainting and unconditional / class-conditional sampling
against sd_tpu's on the CPU in fp32, and both CLIs.

The tiny models' weights go into both packages (tests/torch_parity.py's
``jax_ldm`` and ``ldm_state_dict``), and sd_tpu's draws into the port, made
by sd_tpu's own key splits (DDIM: x_T from the second key of one split, then
a four-way split a step whose first key draws the noise; the ancestral
chain likewise). ``InpaintPipeline`` on the tiny concat model of
``scripts/inpaint.py --tiny`` (the first stage as the cond stage): the [0, 1]
composites within 1e-4 (sd_tpu's read by calling its cached program again),
the pixels outside the mask equal to the input's. The samplers on the tiny
unconditional model (DDIM at eta 1, the ancestral chain) and the tiny
class-conditional one (DDIM with guidance against the last class id) within
rtol 1e-3, atol 1e-3 of the latents' scale (the samplers tests' tolerance on
the tiny UNet); each comparison one jitted JAX program.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.pipelines.img2img import InpaintPipeline as JaxInpaint
from sd_tpu.pipelines.img2img import preprocess_image as jax_preprocess_image
from sd_tpu.pipelines.img2img import preprocess_mask as jax_preprocess_mask
from sd_tpu.samplers import ancestral as jancestral
from sd_tpu.samplers import ddim as jddim
from sd_tpu_torch.pipelines.img2img import InpaintPipeline
from sd_tpu_torch.samplers.ancestral import p_sample_loop
from sd_tpu_torch.samplers.ddim import ddim_sample
from sd_tpu_torch.utils.config import (build_latent_diffusion, tiny_class_cond_model_config,
                                       tiny_inpaint_model_config, tiny_uncond_model_config)
from sd_tpu_torch.utils.testing import load_numpy_state_dict
from torch_parity import jax_ldm, ldm_state_dict, nchw, to_nhwc, torch_threads

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


CONFIGS = {"inpaint": tiny_inpaint_model_config, "uncond": tiny_uncond_model_config,
           "class_cond": tiny_class_cond_model_config}


@functools.lru_cache(maxsize=None)
def both(name):
    """sd_tpu's tiny model ``name`` and the port's with the same weights,
    built once for the module."""
    cfg = CONFIGS[name]()
    jldm = jax_ldm(cfg, np.random.default_rng(0))
    ldm = load_numpy_state_dict(build_latent_diffusion(cfg, device="cpu"),
                                ldm_state_dict(cfg, jldm))
    return jldm, ldm


def image_and_mask(size=32, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    img = np.stack([xx, yy, 0.5 * (xx + yy)], -1) * 255 + rng.normal(0, 16, (size, size, 3))
    mask = np.zeros((size, size), np.float32)
    mask[8:20, 10:26] = 1.0
    return np.clip(img, 0, 255).astype(np.uint8), mask


def test_inpaint_matches_sd_tpu():
    jldm, ldm = both("inpaint")
    img, mask = image_and_mask()
    steps, rng = 4, jax.random.PRNGKey(5)
    jpipe = JaxInpaint(ldm=jldm, downsample=2)
    want_u8 = jpipe(img, mask, rng, steps=steps)
    # sd_tpu's [0, 1] composite: its compiled program, called again on the same inputs
    x = jnp.asarray(jax_preprocess_image(img))
    m_full = jnp.asarray(mask)[None, :, :, None]
    want01 = np.asarray(jpipe._jit_cache[("inpaint", steps)](
        jldm.runtime_params(), x, x * (1.0 - m_full), m_full,
        jnp.asarray(jax_preprocess_mask(mask, 2)), rng))
    # DDIM at eta 0 draws only x_T: the second key of one split
    x_T = np.asarray(jax.random.normal(jax.random.split(rng)[1], (1, 16, 16, 4)))

    pipe = InpaintPipeline(ldm=ldm, downsample=2)
    got_u8 = pipe(img, mask, steps=steps, x_T=torch.from_numpy(np.array(x_T)))
    assert got_u8.shape == want_u8.shape == (1, 32, 32, 3) and got_u8.dtype == np.uint8
    np.testing.assert_allclose(pipe.last_composite, want01, rtol=0, atol=1e-4)
    keep = mask == 0
    np.testing.assert_array_equal(got_u8[0][keep], img[keep])
    np.testing.assert_array_equal(want_u8[0][keep], img[keep])
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1
    assert got_u8[0][~keep].std() > 0
    assert set(pipe.last_timings) == {"encode_s", "sample_s", "decode_s", "total_s"}


def _ddim_draws(rng, steps, shape):
    """sd_tpu's DDIM x_T and per-step noise, NCHW."""
    key, k_init = jax.random.split(rng)
    noise = []
    for _ in range(steps):
        key, k_noise, _, _ = jax.random.split(key, 4)
        noise.append(nchw(jax.random.normal(k_noise, shape)))
    return nchw(jax.random.normal(k_init, shape)), noise


SAMPLER_CASES = ["uncond_ddim_eta1", "uncond_ancestral", "class_cond_ddim_cfg"]


@pytest.mark.parametrize("case", SAMPLER_CASES)
def test_sampler_matches_sd_tpu(case):
    jldm, ldm = both("class_cond" if case.startswith("class") else "uncond")
    shape, rng, steps = (2, 16, 16, 4), jax.random.PRNGKey(6), 4
    # class ids 3 and 11 against the unconditional id 16, the last of 17
    ids = np.array([3, 11]) if case.startswith("class") else None
    cond = uncond = None
    if ids is not None:
        with torch.no_grad():
            cond = ldm.get_learned_conditioning(torch.from_numpy(ids))
            uncond = ldm.get_learned_conditioning(torch.full((2,), 16))
    eta = 1.0 if case == "uncond_ddim_eta1" else 0.0
    guided = dict(guidance_scale=3.0 if ids is not None else 1.0)
    if case == "uncond_ancestral":
        want = jax.jit(lambda p: jancestral.p_sample_loop(
            jldm.bind_params(p).apply_model, jldm.schedule, shape, None, rng,
            timesteps=steps)[0])(jldm.runtime_params())
        key, k_init = jax.random.split(rng)
        noise = []
        for _ in range(steps):
            key, k_noise, _, _ = jax.random.split(key, 4)
            noise.append(nchw(jax.random.normal(k_noise, shape)))
        with torch.no_grad():
            got = p_sample_loop(ldm.apply_model, ldm.schedule, (2, 4, 16, 16),
                                x_T=nchw(jax.random.normal(k_init, shape)), timesteps=steps,
                                noise=noise)
    else:
        def run(p, ids):
            m = jldm.bind_params(p)
            c = u = None
            if ids is not None:
                c = m.get_learned_conditioning(ids)
                u = m.get_learned_conditioning(jnp.full((2,), 16, jnp.int32))
            return jddim.ddim_sample(m.apply_model, m.schedule, shape, c, rng, num_steps=steps,
                                     eta=eta, uncond=u, **guided)[0]

        want = jax.jit(run)(jldm.runtime_params(), None if ids is None else jnp.asarray(ids))
        x_T, noise = _ddim_draws(rng, steps, shape)
        with torch.no_grad():
            got = ddim_sample(ldm.apply_model, ldm.schedule, x_T, cond, num_steps=steps,
                              eta=eta, uncond=uncond, noise=noise, **guided)
    want = np.asarray(want)
    np.testing.assert_allclose(to_nhwc(got), want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


def test_inpaint_cli_writes_its_composites(tmp_path):
    from sd_tpu_torch.scripts.inpaint import main
    from sd_tpu_torch.utils.image import load_image, save_image

    img, mask = image_and_mask(seed=1)
    indir, outdir = tmp_path / "in", tmp_path / "out"
    save_image(img, str(indir / "cat.png"))
    save_image(np.repeat((mask * 255).astype(np.uint8)[..., None], 3, -1),
               str(indir / "cat_mask.png"))
    written = main(["--indir", str(indir), "--outdir", str(outdir), "--tiny", "--device", "cpu",
                    "--steps", "3"])
    assert written == [str(outdir / "cat.png")]
    out = load_image(written[0])
    assert out.shape == (32, 32, 3)
    np.testing.assert_array_equal(out[mask == 0], img[mask == 0])


@pytest.mark.parametrize("extra", [[], ["--classes", "1,5", "--scale", "2.0"]])
def test_sample_diffusion_cli_writes_its_npz(tmp_path, extra):
    from sd_tpu_torch.scripts.sample_diffusion import main

    out = main(["--tiny", "--device", "cpu", "-n", "3", "--batch_size", "2", "--custom_steps",
                "2", "-l", str(tmp_path)] + extra)
    npz = np.load(tmp_path / "3-32x32-samples.npz")["arr_0"]
    assert npz.shape == (3, 32, 32, 3) and npz.dtype == np.uint8
    np.testing.assert_array_equal(npz, out["images"])
    assert sorted(p.name for p in (tmp_path / "img").iterdir()) == [
        "000000.png", "000001.png", "000002.png"]
    assert out["latents"].shape == (3, 4, 16, 16) and len(out["samples_per_s"]) == 2
    assert not np.array_equal(npz[0], npz[1])


def test_training_another_conditioning_key_is_refused():
    """No conditioning key is refused any more (training under each is held
    against sd_tpu in tests/test_torch_train_keys.py): the trainer takes the
    unconditional and the inpainting models, and the unconditional one,
    whose batch has no conditioning entry, trains a step."""
    from sd_tpu_torch.training.diffusion_loss import LDMTrainer, create_train_state

    for cfg, key in ((tiny_uncond_model_config(), None),
                     (tiny_inpaint_model_config(), "concat")):
        trainer = LDMTrainer(ldm=build_latent_diffusion(cfg, device="meta"), base_lr=1e-4)
        assert trainer.ldm.conditioning_key == key
    trainer, state = create_train_state(
        build_latent_diffusion(tiny_uncond_model_config(), device="cpu"), 1e-4, use_ema=False)
    image = np.random.default_rng(0).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    logs = trainer.train_step(state, {"image": image}, torch.Generator().manual_seed(0))
    assert state.step == 1 and np.isfinite(float(logs["loss"]))
