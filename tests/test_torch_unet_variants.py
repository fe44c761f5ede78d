"""The port's UNet variants against sd_tpu's on the CPU in fp32: the legacy
pixel-space attention block in both QKV orders, ``resblock_updown``,
``conv_resample=False``, ``num_heads_upsample``, class labels through the
``adm`` conditioning key, and the codebook head. The same numpy weights go
into both packages (sd_tpu params → sd_tpu_torch.utils.convert →
load_state_dict), the same numpy inputs into both; each comparison is one
jitted JAX program. Tolerance rtol 1e-4, atol 1e-4 of the output's scale, as
in tests/test_torch_models.py. Also: the converter inverts sd_tpu's
``port_unet`` on these layouts, the legacy plan's head counts, and a
resampling ResBlock with a 3x3 skip (``use_conv``, which no UNet config
sets).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from sd_tpu.models import unet as junet
from sd_tpu.models.ldm import LatentDiffusion as JaxLDM
from sd_tpu.ops.resblock import ResBlock as JaxResBlock
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.models.ldm import LatentDiffusion
from sd_tpu_torch.models.unet import UNetConfig, UNetModel, build_unet_plan
from sd_tpu_torch.models.vae import IdentityFirstStage
from sd_tpu_torch.ops.attention import QKVAttentionBlock
from sd_tpu_torch.ops.resblock import ResBlock
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.testing import load_numpy_state_dict, random_state_dict
from torch_parity import nchw, random_params, to_nhwc, torch_threads

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


BASE = dict(image_size=16, in_channels=4, out_channels=4, model_channels=32,
            attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2], num_heads=4)
CASES = {
    "legacy_qkv": dict(),
    "new_attention_order": dict(use_new_attention_order=True, num_heads=-1,
                                num_head_channels=16),
    "resblock_updown_scale_shift": dict(resblock_updown=True, use_scale_shift_norm=True),
    "conv_resample_off": dict(conv_resample=False, attention_resolutions=[1, 2]),
    "num_heads_upsample": dict(num_heads=4, num_heads_upsample=2, channel_mult=[1, 2, 2],
                               attention_resolutions=[2, 4]),
    "class_labels_adm": dict(num_classes=5),
    "codebook_head": dict(n_embed=24),
}


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _configs(case):
    d = dict(BASE, **CASES[case])
    return UNetConfig.from_dict(d), junet.UNetConfig.from_dict(d)


@pytest.mark.parametrize("case", list(CASES))
def test_unet_variant_matches_sd_tpu(case):
    cfg, jcfg = _configs(case)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    t = np.array([981, 21], np.int32)
    y = np.array([3, 0], np.int32)
    jmodel = junet.UNetModel(jcfg)
    jy = jnp.asarray(y) if cfg.num_classes else None
    params = random_params(jmodel, np.random.default_rng(1), jnp.asarray(x), jnp.asarray(t),
                           None, jy)
    unet = load_numpy_state_dict(UNetModel(cfg), {
        **convert.unet_state_dict(params, cfg),
        # the reference keeps `out` beside the codebook head; sd_tpu builds no `out`
        **({k: v.numpy() for k, v in UNetModel(cfg).state_dict().items() if k.startswith("out.")}
           if cfg.n_embed else {})})
    if cfg.num_classes:
        # through the LDM's adm route on both sides, y as a one-element list
        jldm = JaxLDM(unet=jmodel, unet_params=params, schedule=JaxSchedule.create(),
                      conditioning_key="adm")
        want = jax.jit(lambda p, x, t, y: jldm.bind_params({"unet_params": p}).apply_model(
            x, t, {"y": [y]}))(params, jnp.asarray(x), jnp.asarray(t), jy)
        ldm = LatentDiffusion(unet, IdentityFirstStage(), None, DiffusionSchedule.create(),
                              conditioning_key="adm")
        with torch.no_grad():
            got = ldm.apply_model(nchw(x), torch.from_numpy(t), {"y": [torch.from_numpy(y)]})
        # a bare tensor stands for y under adm
        with torch.no_grad():
            again = ldm.apply_model(nchw(x), torch.from_numpy(t), torch.from_numpy(y))
        assert torch.equal(got, again)
    else:
        want = jax.jit(lambda p, x, t: jmodel.apply({"params": p}, x, t))(
            params, jnp.asarray(x), jnp.asarray(t))
        with torch.no_grad():
            got = unet(nchw(x), torch.from_numpy(t))
    assert got.shape[1] == (cfg.n_embed or cfg.out_channels)
    _close(to_nhwc(got), want)


def test_legacy_plan_heads_and_refusals():
    """The legacy block's own head count (the plan never carries a head
    width of -1 into a shape), the output sites' num_heads_upsample, and y
    required exactly for a class-conditional UNet."""
    cfg, _ = _configs("num_heads_upsample")
    plan = build_unet_plan(cfg)
    heads = lambda blocks: [d["heads"] for b in blocks for d in b if d["kind"] == "attention"]
    assert heads(plan["input_blocks"]) == [4, 4] and heads(plan["output_blocks"]) == [2] * 4
    assert heads([plan["middle_block"]]) == [4]
    unet = UNetModel(cfg)
    assert {m.num_heads for m in unet.output_blocks.modules()
            if isinstance(m, QKVAttentionBlock)} == {2}
    cfg, _ = _configs("new_attention_order")
    assert heads(build_unet_plan(cfg)["input_blocks"]) == [64 // 16]
    with pytest.raises(ValueError, match="class-conditional"):
        UNetModel(_configs("class_labels_adm")[0])(torch.zeros(1, 4, 8, 8), torch.zeros(1))
    with pytest.raises(ValueError, match="context_dim"):
        UNetConfig.from_dict(dict(BASE, use_spatial_transformer=True))


@pytest.mark.parametrize("case", ["legacy_qkv", "new_attention_order",
                                  "resblock_updown_scale_shift", "class_labels_adm",
                                  "codebook_head"])
def test_converter_inverts_port_unet(case):
    """A random reference-layout UNet state_dict → sd_tpu's ``port_unet`` →
    convert gives it back (the codebook case without ``out``, which
    ``port_unet`` does not read there). ``port_unet`` reads a resampling
    conv wherever the plan resamples, so conv-less resampling has no porter
    to invert: its conversion is held by the forward test above."""
    cfg, jcfg = _configs(case)
    sd = random_state_dict(UNetModel(cfg), np.random.default_rng(5))
    if cfg.n_embed:
        sd = {k: v for k, v in sd.items() if not k.startswith("out.")}
    back = convert.unet_state_dict(junet.port_unet(sd, jcfg, prefix=""), cfg)
    assert sorted(back) == sorted(sd)
    for key, value in sd.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


@pytest.mark.parametrize("resample", ["down", "up"])
def test_resblock_resample_and_conv_skip_match_sd_tpu(resample):
    x = np.random.default_rng(2).standard_normal((2, 8, 8, 32)).astype(np.float32)
    emb = np.random.default_rng(3).standard_normal((2, 64)).astype(np.float32)
    kw = dict(out_channels=64, use_conv=True, **{resample: True})
    jblock = JaxResBlock(channels=32, emb_channels=64, **kw)
    params = random_params(jblock, np.random.default_rng(4), jnp.asarray(x), jnp.asarray(emb))
    want = jax.jit(lambda p, x, e: jblock.apply({"params": p}, x, e))(
        params, jnp.asarray(x), jnp.asarray(emb))
    sd = {}
    convert._res(sd, params, "")
    block = load_numpy_state_dict(ResBlock(32, 64, **kw), sd)
    assert block.skip_connection.kernel_size == (3, 3)
    with torch.no_grad():
        got = block(nchw(x), torch.from_numpy(emb))
    assert got.shape[2] == (4 if resample == "down" else 16)
    _close(to_nhwc(got), want)
