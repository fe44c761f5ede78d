"""The port's samplers against sd_tpu's on the CPU in fp32, from the same
x_T and the same per-step draws (DDIM, PLMS, DPM-Solver++ and the ancestral
DDPM chain with progressive denoising).

JAX keys and torch generators cannot share a seed, so each test makes
sd_tpu's draws itself, by sd_tpu's own key splits (DDIM: one split off the
key, then four a step: noise, blend noise, dropout keep mask; PLMS: two
splits, then one a step for the blend; the ancestral chain: one split for
x_T, then four a step: noise, blend noise, dropout keep mask), and hands
them to the port as its
per-step sequences. The toy model is elementwise and linear in x, so every
option runs in milliseconds (tolerance rtol 1e-5, atol 1e-5 of the
output's scale); the tiny UNet runs DDIM at eta 1 with a mask and
DPM-Solver++ 2M (rtol 1e-3, atol 1e-3 of the latents' scale, the slice
test's tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from sd_tpu.samplers import ancestral as jancestral
from sd_tpu.samplers import common as jcommon
from sd_tpu.samplers import ddim as jddim
from sd_tpu.samplers import dpm_solver as jdpm
from sd_tpu.samplers.plms import plms_sample as jax_plms_sample
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.samplers import p_sample_loop, progressive_denoising
from sd_tpu_torch.samplers.common import wrap_model_output
from sd_tpu_torch.samplers.ddim import ddim_decode, ddim_sample, ddim_stochastic_encode
from sd_tpu_torch.samplers.dpm_solver import (
    dpm_solver_adaptive_sample,
    dpm_solver_sample,
    dpm_solver_singlestep_sample,
)
from sd_tpu_torch.samplers.plms import plms_sample
from sd_tpu_torch.utils.config import build_latent_diffusion, tiny_sd_model_config
from sd_tpu_torch.utils.testing import load_numpy_state_dict
from torch_parity import ldm_state_dict, nchw, tiny_jax_ldm, to_nhwc, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


KW = dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)
SCHED, JSCHED = DiffusionSchedule.create(**KW), JaxSchedule.create(**KW)
SHAPE = (2, 4, 4, 3)
COND = np.array([0.5, -1.0], np.float32)
UNCOND = np.array([0.2, 0.3], np.float32)


def _rand(seed, shape=SHAPE):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def toy_model(x, t, c):
    """eps = 0.1 x + 1e-3 t c, in either package and either layout."""
    c = c.reshape((-1,) + (1,) * (x.ndim - 1))
    t = t.reshape((-1,) + (1,) * (x.ndim - 1))
    return 0.1 * x + 1e-3 * t * c


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def _guided(use_jax):
    arr = jnp.asarray if use_jax else torch.from_numpy
    return dict(cond=arr(COND), uncond=arr(UNCOND), guidance_scale=7.5)


def ddim_draws(rng, steps, shape, p=0.0):
    """sd_tpu's DDIM draws per step, in NCHW: (noise, blend noise, keep)."""
    key = jax.random.split(rng)[0]
    noise, blend, keep = [], [], []
    for _ in range(steps):
        key, k_noise, k_mask, k_drop = jax.random.split(key, 4)
        noise.append(nchw(jax.random.normal(k_noise, shape)))
        blend.append(nchw(jax.random.normal(k_mask, shape)))
        keep.append(nchw(jax.random.bernoulli(k_drop, 1.0 - p, shape)) if p else None)
    return noise, blend, keep


DDIM_CASES = {
    "eta0": dict(num_steps=7),
    "eta1_temperature_dropout": dict(num_steps=5, eta=1.0, temperature=0.7, noise_dropout=0.3),
    "quad": dict(num_steps=6, eta=0.5, timestep_method="quad"),
    "mask": dict(num_steps=5, eta=1.0, mask=True),
    "original_steps": dict(eta=1.0, use_original_steps=True, t_start_index=30),
    "corrector_quantize_log": dict(num_steps=6, eta=0.3, log_every_t=2, corrected=True),
}


@pytest.mark.parametrize("case", list(DDIM_CASES))
def test_ddim_matches_sd_tpu(case):
    kw = dict(DDIM_CASES[case])
    x_T, rng = _rand(0), jax.random.PRNGKey(4)
    j_kw, t_kw = {}, {}
    if kw.pop("mask", False):
        mask = np.zeros(SHAPE, np.float32)
        mask[:, :2] = 1.0
        x0 = _rand(1)
        j_kw.update(mask=jnp.asarray(mask), x0=jnp.asarray(x0))
        t_kw.update(mask=nchw(mask), x0=nchw(x0))
    if kw.pop("corrected", False):
        j_kw.update(score_corrector=lambda e, x, t, c: 0.9 * e + 0.01 * x,
                    quantize_x0=lambda x: jnp.clip(x, -1.0, 1.0))
        t_kw.update(score_corrector=lambda e, x, t, c: 0.9 * e + 0.01 * x,
                    quantize_x0=lambda x: torch.clamp(x, -1.0, 1.0))
    want, want_inter = jddim.ddim_sample(toy_model, JSCHED, SHAPE, rng=rng, x_T=jnp.asarray(x_T),
                                         **_guided(True), **kw, **j_kw)
    # the grid's length: a step count that does not divide 1000 gives one more
    steps = kw.get("t_start_index") or len(jcommon.build_ddim_tables(
        JSCHED, kw["num_steps"], method=kw.get("timestep_method", "uniform")).timesteps)
    noise, blend, keep = ddim_draws(rng, steps, SHAPE, kw.get("noise_dropout", 0.0))
    got = ddim_sample(toy_model, SCHED, nchw(x_T), noise=noise, mask_noise=blend,
                      dropout_keep=keep if kw.get("noise_dropout") else None,
                      **_guided(False), **kw, **t_kw)
    if kw.get("log_every_t"):
        got, inter = got
        for name in ("x_inter", "pred_x0"):
            got_i = inter[name].permute(0, 1, 3, 4, 2).numpy()
            assert got_i.shape == want_inter[name].shape == (4,) + SHAPE
            _close(got_i, want_inter[name])
    _close(to_nhwc(got), want)


def test_ddim_stochastic_encode_and_decode_match_sd_tpu():
    x0, noise = _rand(2), _rand(3)
    for original in (False, True):
        t_enc = 35 if original else 6
        want = jddim.ddim_stochastic_encode(JSCHED, jnp.asarray(x0), t_enc, None, num_steps=10,
                                            noise=jnp.asarray(noise),
                                            use_original_steps=original)
        got = ddim_stochastic_encode(SCHED, nchw(x0), t_enc, num_steps=10, noise=nchw(noise),
                                     use_original_steps=original)
        _close(to_nhwc(got), want)
        want_z = jddim.ddim_decode(toy_model, JSCHED, want, jnp.asarray(COND), t_enc,
                                   num_steps=10, uncond=jnp.asarray(UNCOND),
                                   guidance_scale=7.5, use_original_steps=original)
        got_z = ddim_decode(toy_model, SCHED, got, torch.from_numpy(COND), t_enc, num_steps=10,
                            uncond=torch.from_numpy(UNCOND), guidance_scale=7.5,
                            use_original_steps=original)
        _close(to_nhwc(got_z), want_z)
    # a [B] tensor of grid positions
    got = ddim_stochastic_encode(SCHED, nchw(x0), torch.tensor([2, 7]), num_steps=10,
                                 noise=nchw(noise))
    want = jddim.ddim_stochastic_encode(JSCHED, jnp.asarray(x0), jnp.asarray([2, 7]), None,
                                        num_steps=10, noise=jnp.asarray(noise))
    _close(to_nhwc(got), want)


@pytest.mark.parametrize("steps", [1, 5])
def test_plms_with_mask_matches_sd_tpu(steps):
    x_T, x0, rng = _rand(5), _rand(6), jax.random.PRNGKey(7)
    mask = np.zeros(SHAPE, np.float32)
    mask[:, 2:] = 1.0
    want, want_inter = jax_plms_sample(toy_model, JSCHED, SHAPE, rng=rng, num_steps=steps,
                                       x_T=jnp.asarray(x_T), mask=jnp.asarray(mask),
                                       x0=jnp.asarray(x0), log_every_t=2, **_guided(True))
    rng = jax.random.split(rng)[0]
    rng, k0 = jax.random.split(rng)
    blend = [nchw(jax.random.normal(k0, SHAPE))]
    for _ in range(steps - 1):
        rng, k = jax.random.split(rng)
        blend.append(nchw(jax.random.normal(k, SHAPE)))
    got, inter = plms_sample(toy_model, SCHED, nchw(x_T), num_steps=steps, mask=nchw(mask),
                             x0=nchw(x0), mask_noise=blend, log_every_t=2, **_guided(False))
    _close(to_nhwc(got), want)
    _close(inter["pred_x0"].permute(0, 1, 3, 4, 2).numpy(), want_inter["pred_x0"])


@pytest.mark.parametrize("order,steps", [(1, 6), (2, 6), (3, 6), (2, 20), (3, 16)])
def test_dpm_solver_multistep_matches_sd_tpu(order, steps):
    x_T = _rand(8)
    want = jdpm.dpm_solver_sample(toy_model, JSCHED, SHAPE, rng=jax.random.PRNGKey(0),
                                  x_T=jnp.asarray(x_T), num_steps=steps, order=order,
                                  **_guided(True))
    got = dpm_solver_sample(toy_model, SCHED, nchw(x_T), num_steps=steps, order=order,
                            **_guided(False))
    _close(to_nhwc(got), want)


@pytest.mark.parametrize("order,steps", [(1, 5), (2, 7), (3, 9), (3, 10), (3, 11)])
def test_dpm_solver_singlestep_matches_sd_tpu(order, steps):
    x_T = _rand(9)
    want = jdpm.dpm_solver_singlestep_sample(toy_model, JSCHED, SHAPE, jnp.asarray(COND),
                                             jax.random.PRNGKey(0), num_steps=steps,
                                             order=order, uncond=jnp.asarray(UNCOND),
                                             guidance_scale=7.5, x_T=jnp.asarray(x_T))
    got = dpm_solver_singlestep_sample(toy_model, SCHED, nchw(x_T), num_steps=steps,
                                       order=order, **_guided(False))
    _close(to_nhwc(got), want)


@pytest.mark.parametrize("order", [2, 3])
def test_dpm_solver_adaptive_matches_sd_tpu(order):
    x_T = _rand(10)
    want = jdpm.dpm_solver_adaptive_sample(toy_model, JSCHED, SHAPE, jnp.asarray(COND),
                                           jax.random.PRNGKey(0), order=order,
                                           uncond=jnp.asarray(UNCOND), guidance_scale=7.5,
                                           x_T=jnp.asarray(x_T))
    got = dpm_solver_adaptive_sample(toy_model, SCHED, nchw(x_T), order=order,
                                     **_guided(False))
    _close(to_nhwc(got), want, rtol=1e-4)


@pytest.mark.parametrize("model_type", ["x_start", "v", "score"])
def test_wrap_model_output_matches_sd_tpu(model_type):
    x = _rand(11)
    t = np.array([17.0, 640.25], np.float32)
    want = jcommon.wrap_model_output(toy_model, JSCHED, model_type)(
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(COND))
    got = wrap_model_output(toy_model, SCHED, model_type)(
        nchw(x), torch.from_numpy(t), torch.from_numpy(COND))
    _close(to_nhwc(got), want)
    # through DPM-Solver++, the wrapper's user in the reference
    want = jdpm.dpm_solver_sample(toy_model, JSCHED, SHAPE, rng=jax.random.PRNGKey(0),
                                  x_T=jnp.asarray(x), num_steps=5, model_type=model_type,
                                  **_guided(True))
    got = dpm_solver_sample(toy_model, SCHED, nchw(x), num_steps=5, model_type=model_type,
                            **_guided(False))
    _close(to_nhwc(got), want, rtol=1e-4)


# ------------------------------------------------------------- tiny UNet


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_sd_model_config()
    jldm = tiny_jax_ldm(cfg, np.random.default_rng(0))
    ldm = load_numpy_state_dict(build_latent_diffusion(cfg, device="cpu"),
                                ldm_state_dict(cfg, jldm))
    cond = _rand(12, (2, 8, 32))
    return jldm, ldm, cond


@pytest.mark.parametrize("sampler", ["ddim_eta1_mask", "dpm2"])
def test_samplers_on_the_tiny_unet_match_sd_tpu(tiny, sampler):
    jldm, ldm, cond = tiny
    shape, steps = (2, 16, 16, 4), 4
    x_T, rng = _rand(13, shape), jax.random.PRNGKey(2)
    args = dict(cond=cond, uncond=0.5 * cond, guidance_scale=7.5)
    j_args = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in args.items()}
    t_args = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
              for k, v in args.items()}
    if sampler == "dpm2":
        want = jax.jit(lambda x: jdpm.dpm_solver_sample(
            jldm.apply_model, jldm.schedule, shape, rng=rng, x_T=x, num_steps=steps,
            **j_args))(jnp.asarray(x_T))
        got = dpm_solver_sample(ldm.apply_model, ldm.schedule, nchw(x_T), num_steps=steps,
                                **t_args)
    else:
        mask = np.zeros(shape, np.float32)
        mask[:, :8] = 1.0
        x0 = _rand(14, shape)
        want, _ = jax.jit(lambda x: jddim.ddim_sample(
            jldm.apply_model, jldm.schedule, shape, rng=rng, x_T=x, num_steps=steps, eta=1.0,
            mask=jnp.asarray(mask), x0=jnp.asarray(x0), **j_args))(jnp.asarray(x_T))
        noise, blend, _ = ddim_draws(rng, steps, shape)
        with torch.no_grad():
            got = ddim_sample(ldm.apply_model, ldm.schedule, nchw(x_T), num_steps=steps,
                              eta=1.0, noise=noise, mask_noise=blend, mask=nchw(mask),
                              x0=nchw(x0), **t_args)
    _close(to_nhwc(got), want, rtol=1e-3)


# ------------------------------------------------------------- ancestral


def ancestral_draws(rng, steps, shape, p=0.0):
    """sd_tpu's p_sample_loop draws, in NCHW: x_T (one split off the key),
    then per step (noise, blend noise, keep) from a four-way split."""
    key, k_init = jax.random.split(rng)
    noise, blend, keep = [], [], []
    for _ in range(steps):
        key, k_noise, k_mask, k_drop = jax.random.split(key, 4)
        noise.append(nchw(jax.random.normal(k_noise, shape)))
        blend.append(nchw(jax.random.normal(k_mask, shape)))
        keep.append(nchw(jax.random.bernoulli(k_drop, 1.0 - p, shape)))
    return nchw(jax.random.normal(k_init, shape)), noise, blend, keep if p else None


ANCESTRAL_CASES = {
    "cfg_quantized_log": dict(timesteps=12, log_every_t=3, guided=True, quantized=True),
    "mask_dropout_temperature_x0": dict(timesteps=10, mask=True, noise_dropout=0.3,
                                        temperature=0.7, parameterization="x0",
                                        clip_denoised=False),
}


@pytest.mark.parametrize("case", list(ANCESTRAL_CASES))
def test_p_sample_loop_matches_sd_tpu(case):
    kw = dict(ANCESTRAL_CASES[case])
    rng = jax.random.PRNGKey(21)
    j_kw, t_kw = {}, {}
    if kw.pop("guided", False):
        j_kw.update(_guided(True))
        t_kw.update(_guided(False))
    else:
        j_kw["cond"], t_kw["cond"] = jnp.asarray(COND), torch.from_numpy(COND)
    if kw.pop("mask", False):
        mask = np.zeros(SHAPE, np.float32)
        mask[:, :, :2] = 1.0
        x0 = _rand(22)
        j_kw.update(mask=jnp.asarray(mask), x0=jnp.asarray(x0))
        t_kw.update(mask=nchw(mask), x0=nchw(x0))
    if kw.pop("quantized", False):
        j_kw["quantize_x0"] = lambda x: jnp.round(x * 4.0) / 4.0
        t_kw["quantize_x0"] = lambda x: torch.round(x * 4.0) / 4.0
    want = jancestral.p_sample_loop(toy_model, JSCHED, SHAPE, rng=rng, **kw, **j_kw)
    steps = kw["timesteps"]
    x_T, noise, blend, keep = ancestral_draws(rng, steps, SHAPE, kw.get("noise_dropout", 0.0))
    got = p_sample_loop(toy_model, SCHED, x_T.shape, x_T=x_T, noise=noise, mask_noise=blend,
                        dropout_keep=keep, **kw, **t_kw)
    if kw.get("log_every_t"):
        got, inter = got
        for name in ("x_inter", "pred_x0"):
            got_i = inter[name].permute(0, 1, 3, 4, 2).numpy()
            assert got_i.shape == want[1][name].shape == (4,) + SHAPE
            _close(got_i, want[1][name])
    else:
        assert want[1] is None
    _close(to_nhwc(got), want[0])


def test_p_sample_loop_draws_x_T_from_the_generator_and_no_noise_at_t0():
    """Without x_T it draws one from the generator first; at t = 0 it adds
    no noise, so a chain of one step is its x0 estimate's posterior mean."""
    model = lambda x, t, c: 0.1 * x
    gen = torch.Generator().manual_seed(5)
    x_T = torch.randn((2, 3, 4, 4), generator=gen)
    a = p_sample_loop(model, SCHED, (2, 3, 4, 4), generator=torch.Generator().manual_seed(5),
                      timesteps=1)
    b = p_sample_loop(model, SCHED, None, x_T=x_T, timesteps=1)
    assert torch.equal(a, b)


def test_progressive_denoising_matches_sd_tpu():
    rng, steps = jax.random.PRNGKey(23), 12
    want_img, want_x0 = jancestral.progressive_denoising(
        toy_model, JSCHED, SHAPE, rng=rng, timesteps=steps, log_every_t=4, **_guided(True))
    x_T, noise, _, _ = ancestral_draws(rng, steps, SHAPE)
    got_img, got_x0 = progressive_denoising(toy_model, SCHED, SHAPE, x_T=x_T, noise=noise,
                                            timesteps=steps, log_every_t=4, **_guided(False))
    _close(to_nhwc(got_img), want_img)
    assert got_x0.shape[0] == want_x0.shape[0] == 3
    _close(got_x0.permute(0, 1, 3, 4, 2).numpy(), want_x0)
