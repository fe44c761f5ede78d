"""The first-stage extras of the port against sd_tpu on the CPU.

Each module of ``sd_tpu_torch/models/vae_extras.py`` and ``resize`` against
``sd_tpu/models/vae_extras.py`` from the same parameters (sd_tpu's, made
with numpy from a seed and carried over by ``utils/convert.py``) and the
same seeded numpy inputs, in fp32: ``TimestepVAEModel`` with its timestep
embedding and a context, and its state dict read back by sd_tpu's
``port_timestep_model`` (the reference layout); ``VAEResnetBlock`` with a
``temb_proj`` and with a 3x3 ``conv_shortcut``, on the plain path and on the
fused (K7) path, whose CPU version is the kernel's plain version. The bound
is 1e-4 of the output's scale (max |sd_tpu|): fp32 on both sides, the same
operations summed in other orders. Last, ``VAEAttnBlock`` at C = 640 and
1024 (one head, N = 64) reaches K1's wrapper, which K1's split plan takes
on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.models import vae_extras as jx
from sd_tpu.ops.resblock import VAEResnetBlock as JaxVAEResnetBlock
from sd_tpu_torch.models import vae_extras as px
from sd_tpu_torch.ops import attention as port_attention
from sd_tpu_torch.ops.attention import VAEAttnBlock
from sd_tpu_torch.ops.cuda import flash_attention_plain
from sd_tpu_torch.ops.resblock import VAEResnetBlock
from sd_tpu_torch.utils import convert
from torch_parity import nchw, random_params, torch_threads

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _load(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    module.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                           strict=True)
    return module.eval()


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=TOL * scale)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("case", ["temb", "conv_shortcut", "temb_fused"])
def test_vae_resnet_block(case):
    """temb_proj added after conv1, the 3x3 shortcut, and the temb term in
    the fused path's second GroupNorm fold."""
    rng = np.random.default_rng(0)
    fused = case == "temb_fused"
    cin, cout, h, w = (128, 256, 8, 16) if fused else (32, 64, 6, 6)
    kw = dict(conv_shortcut=True) if case == "conv_shortcut" else dict(temb_channels=16)
    jblock = JaxVAEResnetBlock(in_channels=cin, out_channels=cout, **kw)
    x = _rand(rng, 2, h, w, cin)
    temb = _rand(rng, 2, 16) if "temb" in case else None
    params = random_params(jblock, rng, jnp.asarray(x),
                           None if temb is None else jnp.asarray(temb))
    want = jblock.apply({"params": params}, jnp.asarray(x),
                        None if temb is None else jnp.asarray(temb))
    block = _load(VAEResnetBlock(cin, cout, **kw), convert.vae_resnet_block_state_dict(params))
    assert hasattr(block, "temb_proj") == ("temb" in case)
    assert hasattr(block, "conv_shortcut") == (case == "conv_shortcut")
    if fused:
        block.conv_impl = "force"
        calls = []
        real = block._fused
        block._fused = lambda *a: calls.append(1) or real(*a)
    got = block(nchw(x), None if temb is None else torch.from_numpy(temb))
    if fused:
        assert calls == [1]
    _close(got.permute(0, 2, 3, 1), want)


def _extras_case(name, rng):
    """(sd_tpu module, port module, state-dict converter, NHWC input)."""
    if name == "SimpleDecoder":
        return (jx.SimpleDecoder(in_channels=32, out_channels=3),
                px.SimpleDecoder(32, 3), convert.simple_decoder_state_dict, _rand(rng, 1, 6, 6, 32))
    if name == "UpsampleDecoder":
        kw = dict(in_channels=32, out_channels=3, ch=32, num_res_blocks=1, resolution=8,
                  ch_mult=(1, 2))
        return (jx.UpsampleDecoder(**kw), px.UpsampleDecoder(**kw),
                convert.upsample_decoder_state_dict, _rand(rng, 1, 8, 8, 32))
    if name == "LatentRescaler":
        # factor 1.5 on 6x6: jax.image.resize's nearest (half-pixel centres)
        kw = dict(factor=1.5, in_channels=16, mid_channels=32, out_channels=8, depth=1)
        return (jx.LatentRescaler(**kw), px.LatentRescaler(**kw),
                convert.latent_rescaler_state_dict, _rand(rng, 1, 6, 6, 16))
    if name == "MergedRescaleEncoder":
        kw = dict(in_channels=3, ch=32, resolution=16, out_ch=8, num_res_blocks=1,
                  attn_resolutions=(8,), ch_mult=(1, 2), rescale_factor=1.0,
                  rescale_module_depth=1)
        return (jx.MergedRescaleEncoder(**kw), px.MergedRescaleEncoder(**kw),
                lambda p: convert.merged_rescale_encoder_state_dict(p, 1, (1, 2)),
                _rand(rng, 1, 16, 16, 3))
    if name == "MergedRescaleDecoder":
        kw = dict(z_channels=8, out_ch=3, resolution=16, num_res_blocks=1, ch=32,
                  ch_mult=(1, 4), rescale_factor=1.0, rescale_module_depth=1)
        return (jx.MergedRescaleDecoder(**kw), px.MergedRescaleDecoder(**kw),
                lambda p: convert.merged_rescale_decoder_state_dict(p, 1, (1, 4)),
                _rand(rng, 1, 8, 8, 8))
    if name == "Upsampler":
        kw = dict(in_size=8, out_size=16, in_channels=32, out_channels=3, ch_mult=2)
        return (jx.Upsampler(**kw), px.Upsampler(**kw),
                lambda p: convert.merged_rescale_decoder_state_dict(p, 2, (2, 2)),
                _rand(rng, 1, 8, 8, 32))
    if name == "FirstStagePostProcessor":
        kw = dict(ch_mult=(1, 2), in_channels=8, n_channels=32, reshape=True)
        return (jx.FirstStagePostProcessor(**kw), px.FirstStagePostProcessor(**kw),
                convert.first_stage_post_processor_state_dict, _rand(rng, 1, 8, 8, 8))
    raise ValueError(name)


@pytest.mark.parametrize("name", ["SimpleDecoder", "UpsampleDecoder", "LatentRescaler",
                                  "MergedRescaleEncoder", "MergedRescaleDecoder", "Upsampler",
                                  "FirstStagePostProcessor"])
def test_extras_module(name):
    rng = np.random.default_rng(1)
    jmod, module, to_sd, x = _extras_case(name, rng)
    params = random_params(jmod, rng, jnp.asarray(x))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    got = _load(module, to_sd(params))(nchw(x))
    if got.ndim == 4:
        got = got.permute(0, 2, 3, 1)
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("scale,mode", [(0.5, "bilinear"), (1.5, "bilinear"), (0.75, "nearest"),
                                        (2.0, "bicubic"), (1.0, "bilinear")])
def test_resize(scale, mode):
    """``jax.image.resize``'s weights: antialiased where it shrinks."""
    x = _rand(np.random.default_rng(2), 2, 12, 10, 3)
    want = np.asarray(jx.resize(jnp.asarray(x), scale_factor=scale, mode=mode))
    got = px.resize(nchw(x), scale_factor=scale, mode=mode).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    _close(got, want)


def test_vae_timestep_embedding():
    """sin first, frequencies over half - 1; an odd width padded. Absolute
    bound 1e-4: at t = 999 an fp32 argument is known to 6.1e-5 (its ulp),
    and the two libraries' exp round the frequencies differently."""
    t = np.array([0, 3, 999], np.int32)
    for dim in (32, 33):
        want = np.asarray(jx._vae_timestep_embedding(jnp.asarray(t), dim))
        got = px.vae_timestep_embedding(torch.from_numpy(t), dim)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_timestep_model_with_temb_and_context():
    """TimestepVAEModel with a timestep and a 2-channel context against
    sd_tpu's; its state dict in the reference layout that sd_tpu's
    port_timestep_model reads back to the same parameters."""
    rng = np.random.default_rng(3)
    cfg = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
               resolution=16)
    jmodel = jx.TimestepVAEModel(**cfg)
    x, ctx = _rand(rng, 2, 16, 16, 3), _rand(rng, 2, 16, 16, 2)
    t = np.array([10, 500], np.int32)
    params = random_params(jmodel, rng, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    sd = convert.timestep_model_state_dict(params, cfg)
    model = _load(px.TimestepVAEModel(in_channels=5, **cfg), sd)
    got = model(nchw(x), torch.from_numpy(t), nchw(ctx))
    _close(got.permute(0, 2, 3, 1), want)
    back = jx.port_timestep_model({k: torch.from_numpy(v) for k, v in sd.items()},
                                  dict(cfg, attn_resolutions=[8]))
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v)
                         for k, v in jax.tree_util.tree_leaves_with_path(tree)}
    ref, got_params = flat(params), flat(back)
    assert set(ref) == set(got_params)
    for key, value in ref.items():
        np.testing.assert_array_equal(got_params[key], value, err_msg=key)


@pytest.mark.parametrize("c", [640, 1024])
def test_vae_attn_block_routes_to_k1(monkeypatch, c):
    """A one-head VAEAttnBlock at head dim C above the old 576 reaches K1's
    wrapper (on the CPU its plain version) and not the refusal."""
    calls = []
    monkeypatch.setattr(port_attention, "differentiable_flash_attention",
                        lambda q, k, v, scale=None: calls.append(q.shape)
                        or flash_attention_plain(q, k, v, scale))
    rng = np.random.default_rng(4)
    block = VAEAttnBlock(c).eval()
    x = torch.from_numpy(_rand(rng, 1, c, 8, 8))
    with torch.no_grad():
        out = block(x)
    assert calls == [(1, 64, 1, c)]
    assert torch.isfinite(out).all() and out.shape == x.shape
