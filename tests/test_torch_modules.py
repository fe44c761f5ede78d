"""The port's building blocks against sd_tpu's on the CPU in fp32: the same
numpy inputs and the same weights (through sd_tpu_torch.utils.convert) go
into both. Tolerance rtol 1e-5 / atol 1e-5 unless a test says otherwise."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from sd_tpu.core.schedules import timestep_embedding as jax_timestep_embedding
from sd_tpu.ops import attention as jattn
from sd_tpu.ops import norms as jnorms
from sd_tpu.ops import resblock as jres
from sd_tpu.samplers.common import build_ddim_tables as jax_ddim_tables
from sd_tpu.samplers.plms import plms_sample as jax_plms_sample
from sd_tpu_torch.core.schedules import DiffusionSchedule, timestep_embedding
from sd_tpu_torch.ops.attention import SpatialTransformer, VAEAttnBlock
from sd_tpu_torch.ops.norms import GroupNorm32, LayerNormFp32
from sd_tpu_torch.ops.resblock import ResBlock, VAEResnetBlock
from sd_tpu_torch.samplers.common import build_ddim_tables
from sd_tpu_torch.samplers.plms import plms_sample
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.testing import load_numpy_state_dict, randomize_tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)


def _nhwc(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _flax(module, seed, *args):
    """Init ``module`` on ``args``, randomize every parameter, apply."""
    params = randomize_tree(module.init(jax.random.PRNGKey(0), *args)["params"],
                            np.random.default_rng(seed))
    return params, np.asarray(module.apply({"params": params}, *args))


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_groupnorm32(eps):
    x = 3.0 + 2.0 * _nhwc(0, (2, 8, 8, 64))
    p, want = _flax(jnorms.GroupNorm32(eps=eps), 1, jnp.asarray(x))
    gn = load_numpy_state_dict(GroupNorm32(64, eps=eps), convert._norm(p["GroupNorm_0"]))
    np.testing.assert_allclose(_to_nhwc(gn(_nchw(x))), want, **TOL)


def test_groupnorm32_constant_input_finite():
    """A constant input can round the single-pass variance negative; the clamp
    keeps rsqrt finite (sd_tpu's test_groupnorm32_constant_input_finite)."""
    gn = GroupNorm32(64)
    x = torch.full((2, 64, 8, 8), 7.123456, dtype=torch.float32)
    out = gn(x)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.detach().numpy(), 0.0, atol=1e-3)


def test_layernorm_fp32():
    x = _nhwc(2, (2, 16, 48))
    p, want = _flax(jnorms.LayerNormFp32(), 3, jnp.asarray(x))
    ln = load_numpy_state_dict(LayerNormFp32(48), convert._norm(p["LayerNorm_0"]))
    np.testing.assert_allclose(ln(torch.from_numpy(x)).detach().numpy(), want, **TOL)


def test_timestep_embedding():
    """sd_tpu's frequency table comes from XLA's float32 exp, the port's is
    float64 rounded once; they differ by at most one float32 ulp, so the
    argument t·f (f <= 1) may round to a neighbouring float32: up to
    t·2^-23 on top of the 1e-5 tolerance."""
    t = np.arange(0, 1000, 37).astype(np.int32)
    for dim in (320, 33):
        want = np.asarray(jax_timestep_embedding(jnp.asarray(t), dim))
        got = timestep_embedding(torch.from_numpy(t), dim).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        assert (np.abs(got - want) <= 1e-5 + t[:, None] * 2.0**-23).all()


@pytest.mark.parametrize("kind", ["linear", "cosine"])
def test_schedule_tables_exact(kind):
    kw = dict(timesteps=1000, beta_schedule=kind, linear_start=0.00085, linear_end=0.012)
    got, want = DiffusionSchedule.create(**kw), JaxSchedule.create(**kw)
    for field in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, field.name), getattr(want, field.name),
                                      err_msg=field.name)
    for steps in (50, 7):
        for a, b in zip(build_ddim_tables(got, steps), jax_ddim_tables(want, steps)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cin,cout,film", [(32, 64, False), (64, 64, False), (32, 64, True)])
def test_resblock(cin, cout, film):
    x, emb = _nhwc(4, (2, 8, 8, cin)), _nhwc(5, (2, 128))
    p, want = _flax(jres.ResBlock(channels=cin, emb_channels=128, out_channels=cout,
                                  use_scale_shift_norm=film), 6,
                    jnp.asarray(x), jnp.asarray(emb))
    sd = {}
    convert._res(sd, p, "")
    block = load_numpy_state_dict(ResBlock(cin, 128, out_channels=cout,
                                           use_scale_shift_norm=film), sd)
    got = block(_nchw(x), torch.from_numpy(emb))
    np.testing.assert_allclose(_to_nhwc(got), want, **TOL)


def test_vae_resnet_block():
    x = _nhwc(7, (1, 8, 8, 32))
    p, want = _flax(jres.VAEResnetBlock(in_channels=32, out_channels=64), 8, jnp.asarray(x))
    sd = {}
    convert._vae_res(sd, p, "")
    block = load_numpy_state_dict(VAEResnetBlock(32, 64), sd)
    np.testing.assert_allclose(_to_nhwc(block(_nchw(x))), want, **TOL)


def test_spatial_transformer_with_context():
    x, ctx = _nhwc(9, (2, 8, 8, 64)), _nhwc(10, (2, 7, 24))
    p, want = _flax(jattn.SpatialTransformer(in_channels=64, n_heads=4, d_head=16,
                                             context_dim=24), 11,
                    jnp.asarray(x), jnp.asarray(ctx))
    sd = {}
    convert._unet_layer(sd, dict(kind="spatial_transformer", depth=1), p, "")
    st = load_numpy_state_dict(SpatialTransformer(64, 4, 16, context_dim=24), sd)
    got = st(_nchw(x), torch.from_numpy(ctx))
    np.testing.assert_allclose(_to_nhwc(got), want, **TOL)


def test_vae_attn_block():
    x = _nhwc(12, (1, 8, 8, 64))
    p, want = _flax(jattn.VAEAttnBlock(in_channels=64), 13, jnp.asarray(x))
    sd = {}
    convert._vae_attn(sd, p, "")
    block = load_numpy_state_dict(VAEAttnBlock(64), sd)
    np.testing.assert_allclose(_to_nhwc(block(_nchw(x))), want, **TOL)


@pytest.mark.parametrize("steps", [1, 6])
def test_plms_sampler(steps):
    """Both PLMS loops on one elementwise eps model, with guidance: the
    bootstrap, the order 2/3/4 ring and the DDIM update agree."""
    kw = dict(timesteps=1000, linear_start=0.00085, linear_end=0.012)
    x_T = _nhwc(14, (2, 4, 4, 3))
    cond = np.array([0.5, -1.0], np.float32)
    uncond = np.array([0.2, 0.3], np.float32)

    def jax_model(x, t, c):
        return 0.1 * x + 1e-3 * t.reshape(-1, 1, 1, 1) * c.reshape(-1, 1, 1, 1)

    want, _ = jax_plms_sample(jax_model, JaxSchedule.create(**kw), x_T.shape,
                              jnp.asarray(cond), jax.random.PRNGKey(0), num_steps=steps,
                              uncond=jnp.asarray(uncond), guidance_scale=7.5,
                              x_T=jnp.asarray(x_T))
    got = plms_sample(jax_model, DiffusionSchedule.create(**kw), _nchw(x_T),
                      torch.from_numpy(cond), num_steps=steps,
                      uncond=torch.from_numpy(uncond), guidance_scale=7.5)
    np.testing.assert_allclose(_to_nhwc(got), np.asarray(want), **TOL)
