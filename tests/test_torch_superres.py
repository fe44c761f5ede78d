"""Super-resolution, tiling and spatial conditioning in the port against
sd_tpu on the CPU, in fp32, from the same numpy inputs and parameters.

- ``pipelines/tiled.py``: the stitching weights, patches and their fold on
  an even and an uneven grid (the right-aligned last patch), and
  ``tiled_apply`` with ``out_scale`` 2 and 1/2, within 1e-6;
- ``LatentDiffusion.split_input_params``: the tiled ``apply_model`` with
  concat (a tiny VQ super-resolution model), crossattn (a ClassEmbedder's
  context), ``y`` (the adm key) and ``coordinates_bbox`` (a
  ``BBoxTokenizer``'s layout through a TransformerEmbedder), and the
  patch-distributed first-stage encode and decode, KL and VQ (with and
  without quantization, each flag in its package's sense), within 1e-4 of
  the output's scale;
- ``SpatialRescaler`` (every method, shrinking with antialiasing and
  growing, with and without ``channel_mapper``) and ``HybridConditioner``,
  within 1e-5;
- ``SuperResPipeline``, untiled and tiled, fed sd_tpu's x_T and per-step
  noise (sd_tpu's key splits, as tests/test_torch_inpaint_sample.py draws
  them): the [0, 1] images before the uint8 rounding within 1e-4.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.data.layout import BBoxTokenizer as JaxBBoxTokenizer
from sd_tpu.models import encoders as jenc
from sd_tpu.pipelines import tiled as jtiled
from sd_tpu.pipelines.superres import SuperResPipeline as JaxSuperRes
from sd_tpu.pipelines.superres import prepare_sr_cond as jax_prepare_sr_cond
from sd_tpu_torch.data.layout import BBoxTokenizer
from sd_tpu_torch.models.encoders import HybridConditioner, SpatialRescaler
from sd_tpu_torch.pipelines import tiled
from sd_tpu_torch.pipelines.superres import SuperResPipeline
from sd_tpu_torch.utils import config, convert
from sd_tpu_torch.utils.config import build_latent_diffusion, tiny_class_cond_model_config
from sd_tpu_torch.utils.testing import load_numpy_state_dict
from torch_parity import jax_ldm, ldm_state_dict, nchw, random_params, to_nhwc, torch_threads

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _close(got, want, scale_tol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=scale_tol, atol=scale_tol * np.abs(want).max())


# ------------------------------------------------------------------ tiled.py


@pytest.mark.parametrize("ks", [8, 13, 64])
def test_tiling_weights_match_sd_tpu(ks):
    np.testing.assert_allclose(tiled.tiling_weights(ks, 0.02, 0.4),
                               jtiled.tiling_weights(ks, 0.02, 0.4), rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw, ks, stride", [((16, 16), 8, 4), ((14, 19), 8, 5)],
                         ids=["even", "uneven"])
def test_patches_and_fold_match_sd_tpu(hw, ks, stride):
    x = np.random.default_rng(0).standard_normal((2,) + hw + (3,)).astype(np.float32)
    want, jsy, jsx = jtiled.extract_patches(jnp.asarray(x), ks, stride)
    got, sy, sx = tiled.extract_patches(nchw(x), ks, stride)
    assert list(sy) == list(jsy) and list(sx) == list(jsx)
    assert sy[-1] == hw[0] - ks and sx[-1] == hw[1] - ks
    np.testing.assert_array_equal(got.permute(0, 1, 3, 4, 2).numpy(), np.asarray(want))
    # a fold of patches that are not the canvas's own
    p = np.random.default_rng(1).standard_normal(np.asarray(want).shape).astype(np.float32)
    folded = jtiled.fold_patches(jnp.asarray(p), hw, ks, jsy, jsx)
    got = tiled.fold_patches(torch.from_numpy(p).permute(0, 1, 4, 2, 3), hw, ks, sy, sx)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(folded), rtol=0, atol=1e-6)


@pytest.mark.parametrize("out_scale", [2, 0.5])
def test_tiled_apply_matches_sd_tpu(out_scale):
    """A patch function that depends on each patch (its mean) and resamples
    it by ``out_scale``: nearest doubling, or 2x2 mean pooling."""
    x = np.random.default_rng(2).standard_normal((2, 20, 24, 3)).astype(np.float32)

    def jfn(p):
        p = p + p.mean(axis=(1, 2, 3), keepdims=True)
        if out_scale == 2:
            return jnp.repeat(jnp.repeat(p, 2, axis=1), 2, axis=2)
        n, h, w, c = p.shape
        return p.reshape(n, h // 2, 2, w // 2, 2, c).mean(axis=(2, 4))

    def fn(p):
        p = p + p.mean(dim=(1, 2, 3), keepdim=True)
        if out_scale == 2:
            return p.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return torch.nn.functional.avg_pool2d(p, 2)

    want = jtiled.tiled_apply(jfn, jnp.asarray(x), ks=8, stride=4, out_scale=out_scale)
    got = tiled.tiled_apply(fn, nchw(x), ks=8, stride=4, out_scale=out_scale)
    assert got.shape[2:] == (int(20 * out_scale), int(24 * out_scale))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=0, atol=1e-6)


# ---------------------------------------------------------- the tiny models


def tiny_sr_config():
    """bsr_sr's layout at narrow width: a concat UNet (3 + 3 channels,
    legacy attention of 16-channel heads), an f2 VQ first stage, the LR
    image through torch.nn.Identity under LR_image."""
    return {"target": "ldm.models.diffusion.ddpm.LatentDiffusion", "params": {
        "linear_start": 0.0015, "linear_end": 0.0155, "timesteps": 1000,
        "cond_stage_key": "LR_image", "image_size": 16, "channels": 3,
        "conditioning_key": "concat",
        "unet_config": {"target": "ldm.modules.diffusionmodules.openaimodel.UNetModel",
                        "params": {"image_size": 16, "in_channels": 6, "out_channels": 3,
                                   "model_channels": 32, "attention_resolutions": [2],
                                   "num_res_blocks": 1, "channel_mult": [1, 2],
                                   "num_head_channels": 16}},
        "first_stage_config": {"target": "ldm.models.autoencoder.VQModelInterface", "params": {
            "embed_dim": 3, "n_embed": 16,
            "ddconfig": {"double_z": False, "z_channels": 3, "resolution": 32,
                         "in_channels": 3, "out_ch": 3, "ch": 32, "ch_mult": [1, 2],
                         "num_res_blocks": 1, "attn_resolutions": [], "dropout": 0.0}}},
        "cond_stage_config": {"target": "torch.nn.Identity"}}}


def tiny_adm_config():
    cfg = tiny_class_cond_model_config()
    cfg["params"]["conditioning_key"] = "adm"
    cfg["params"]["unet_config"]["params"].update(use_spatial_transformer=False,
                                                  context_dim=None, num_classes=5)
    return cfg


BBOX = BBoxTokenizer(n_classes=6, n_bins=16, max_objects=3)


def tiny_bbox_config():
    cfg = tiny_class_cond_model_config()
    p = cfg["params"]
    p["cond_stage_key"] = "coordinates_bbox"
    p["cond_stage_config"] = {"target": "ldm.modules.encoders.modules.TransformerEmbedder",
                              "params": {"n_embed": 32, "n_layer": 1,
                                         "vocab_size": BBOX.vocab_size,
                                         "max_seq_len": BBOX.seq_len}}
    return cfg


CONFIGS = {"sr": tiny_sr_config, "class_cond": tiny_class_cond_model_config,
           "adm": tiny_adm_config, "bbox": tiny_bbox_config}


@functools.lru_cache(maxsize=None)
def both(name):
    """sd_tpu's tiny model ``name`` and the port's with the same weights."""
    cfg = CONFIGS[name]()
    rng = np.random.default_rng(10)
    if name == "bbox":  # the class-conditional model with a TransformerEmbedder
        jldm = both("class_cond")[0]
        sd = {k: v for k, v in ldm_state_dict(tiny_class_cond_model_config(), jldm).items()
              if not k.startswith("cond_stage_model.")}
        cond = jenc.TransformerEmbedder(n_embed=32, n_layer=1, vocab_size=BBOX.vocab_size,
                                        max_seq_len=BBOX.seq_len)
        params = random_params(cond, rng, jnp.zeros((1, BBOX.seq_len), jnp.int32))
        jldm = dataclasses.replace(jldm, cond_stage_model=cond, cond_stage_params=params,
                                   cond_stage_key="coordinates_bbox",
                                   bbox_tokenizer=JaxBBoxTokenizer(6, 16, 3))
        sd.update({"cond_stage_model." + k: v for k, v in
                   convert.transformer_embedder_state_dict(params, 1).items()})
    else:
        jldm = jax_ldm(cfg, rng)
        if name == "sr":  # jax_ldm keeps sd_tpu's default cond_stage_key
            jldm = dataclasses.replace(jldm, cond_stage_key="LR_image")
        sd = ldm_state_dict(cfg, jldm)
    ldm = load_numpy_state_dict(build_latent_diffusion(cfg, device="cpu"), sd)
    if name == "bbox":
        ldm.bbox_tokenizer = BBOX
    return jldm, ldm


SPLIT = {"ks": 8, "stride": 4, "vqf": 2, "original_image_size": (24, 28)}


@pytest.mark.parametrize("case", ["concat", "crossattn", "y", "coordinates_bbox"])
def test_split_input_params_apply_model_matches_sd_tpu(case):
    """x [2, 12, 14] latents in patches of 8 at a stride of 4: a 2 x 3 grid,
    its last column right-aligned, all 12 patches in one UNet call."""
    name = {"concat": "sr", "crossattn": "class_cond", "y": "adm",
            "coordinates_bbox": "bbox"}[case]
    jldm, ldm = both(name)
    rng = np.random.default_rng(11)
    channels = 3 if name == "sr" else 4
    x = rng.standard_normal((2, 12, 14, channels)).astype(np.float32)
    t = np.array([10, 700], np.int32)
    if case == "concat":
        jc = rng.standard_normal((2, 12, 14, 3)).astype(np.float32)
        c = {"c_concat": [nchw(jc)]}
        jc = {"c_concat": [jc]}
    elif case == "crossattn":
        ids = np.array([2, 9], np.int32)
        jc = np.array(jldm.get_learned_conditioning(jnp.asarray(ids)))
        c = torch.from_numpy(jc)
    elif case == "y":
        jc = {"y": np.array([1, 4], np.int32)}
        c = {"y": torch.from_numpy(jc["y"]).long()}
    else:
        layouts = [[(1, 0.1, 0.2, 0.6, 0.7), (4, 0.5, 0.5, 0.9, 0.8)], [(0, 0.0, 0.3, 0.4, 1.0)]]
        jc = BBOX(layouts)
        np.testing.assert_array_equal(jc, JaxBBoxTokenizer(6, 16, 3)(layouts))
        c = torch.from_numpy(jc).long()
    jm = dataclasses.replace(jldm, split_input_params=SPLIT)
    ldm.split_input_params = SPLIT
    try:
        want = jax.jit(lambda p, x, t, c: jm.bind_params(p).apply_model(x, t, c))(
            jm.runtime_params(), x, t, jc)
        with torch.no_grad():
            got = ldm.apply_model(nchw(x), torch.from_numpy(t).long(), c)
    finally:
        ldm.split_input_params = None
    _close(to_nhwc(got), want, 1e-4)


@pytest.mark.parametrize("case", ["kl encode", "kl decode", "vq encode", "vq decode",
                                  "vq decode unquantized"])
def test_patch_distributed_first_stage_matches_sd_tpu(case):
    """Images [2, 24, 28] in patches of 16 at a stride of 8 (latent patches
    of 8 at 4, vqf 2)."""
    jldm, ldm = both("class_cond" if case.startswith("kl") else "sr")
    split = dict(SPLIT, ks=16, stride=8, patch_distributed_vq=True)
    jm = dataclasses.replace(jldm, split_input_params=split)
    ldm.split_input_params = split
    rng = np.random.default_rng(12)
    try:
        if case.endswith("encode"):
            x = rng.uniform(-1, 1, (2, 24, 28, 3)).astype(np.float32)
            want = jax.jit(lambda p, x: jm.bind_params(p).encode_first_stage(x))(
                jm.runtime_params(), x)
            with torch.no_grad():
                got = ldm.encode_first_stage(nchw(x))
            if case.startswith("kl"):
                _close(to_nhwc(got.mean), want.mean, 1e-4)
                _close(to_nhwc(got.logvar), want.logvar, 1e-4)
            else:
                _close(to_nhwc(got), want, 1e-4)
            return
        z = rng.standard_normal((2, 12, 14, 3 if case.startswith("vq") else 4)).astype(
            np.float32)
        quantize = case != "vq decode unquantized"
        # sd_tpu's flag quantizes when True, the port's (the reference's) when False
        want = jax.jit(lambda p, z: jm.bind_params(p).decode_first_stage(
            z, force_not_quantize=quantize))(jm.runtime_params(), z)
        with torch.no_grad():
            got = ldm.decode_first_stage(nchw(z), force_not_quantize=not quantize)
        assert got.shape == (2, 3, 24, 28)
        _close(to_nhwc(got), want, 1e-4)
    finally:
        ldm.split_input_params = None


# ----------------------------------------------------- spatial conditioning


RESCALERS = {"bilinear down x2 stages": dict(n_stages=2, method="bilinear", multiplier=0.5),
             "bilinear up": dict(n_stages=1, method="bilinear", multiplier=1.5),
             "area with channel_mapper": dict(n_stages=1, method="area", multiplier=0.5,
                                              out_channels=5),
             "bicubic down with channel_mapper": dict(n_stages=1, method="bicubic",
                                                      multiplier=0.7, out_channels=4),
             "nearest": dict(n_stages=1, method="nearest", multiplier=0.6),
             "linear up": dict(n_stages=1, method="linear", multiplier=2.0),
             "trilinear": dict(n_stages=1, method="trilinear", multiplier=0.5)}


@pytest.mark.parametrize("case", list(RESCALERS))
def test_spatial_rescaler_matches_sd_tpu(case):
    kw = RESCALERS[case]
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 20, 18, 3)).astype(np.float32)
    jmod = jenc.SpatialRescaler(**kw)
    # a rescaler without channel_mapper has no parameters
    params = random_params(jmod, rng, jnp.zeros((1, 20, 18, 3))) if "out_channels" in kw else {}
    want = jmod.apply({"params": params}, jnp.asarray(x))
    mod = load_numpy_state_dict(SpatialRescaler(**kw), convert.spatial_rescaler_state_dict(
        params))
    assert (mod.channel_mapper is None) == ("out_channels" not in kw)
    with torch.no_grad():
        got = mod.encode(nchw(x))
    assert got.shape == tuple(np.asarray(want).transpose(0, 3, 1, 2).shape)
    _close(to_nhwc(got), want, 1e-5)


def test_hybrid_conditioner_matches_sd_tpu_and_builds_from_its_configs():
    rng = np.random.default_rng(14)
    jconcat = jenc.SpatialRescaler(n_stages=1, multiplier=0.5, out_channels=4)
    jcross = jenc.ClassEmbedder(embed_dim=8, n_classes=5)
    jmod = jenc.HybridConditioner(concat_conditioner=jconcat, crossattn_conditioner=jcross)
    x = rng.standard_normal((2, 16, 12, 3)).astype(np.float32)
    ids = np.array([1, 3], np.int32)
    params = random_params(jmod, rng, jnp.zeros((1, 16, 12, 3)), jnp.zeros((1,), jnp.int32))
    want = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(ids))
    mod = config.instantiate_from_config({
        "target": "ldm.modules.diffusionmodules.util.HybridConditioner",
        "params": {"c_concat_config": {"target": "ldm.modules.encoders.modules.SpatialRescaler",
                                       "params": {"multiplier": 0.5, "out_channels": 4}},
                   "c_crossattn_config": {"target": "ldm.modules.encoders.modules.ClassEmbedder",
                                          "params": {"embed_dim": 8, "n_classes": 5}}}})
    assert isinstance(mod, HybridConditioner)
    sd = {"concat_conditioner." + k: v for k, v in
          convert.spatial_rescaler_state_dict(params["concat_conditioner"]).items()}
    sd.update({"crossattn_conditioner." + k: v for k, v in
               convert.class_embedder_state_dict(params["crossattn_conditioner"]).items()})
    load_numpy_state_dict(mod, sd)
    with torch.no_grad():
        got = mod(nchw(x), torch.from_numpy(ids))
    assert set(got) == {"c_concat", "c_crossattn"} and len(got["c_concat"]) == 1
    _close(to_nhwc(got["c_concat"][0]), want["c_concat"][0], 1e-5)
    _close(got["c_crossattn"][0].numpy(), want["c_crossattn"][0], 1e-5)


# ---------------------------------------------------------------- superres


def _ddim_draws(rng, steps, shape):
    """sd_tpu's DDIM x_T and per-step noise, NHWC."""
    key, k_init = jax.random.split(rng)
    noise = []
    for _ in range(steps):
        key, k_noise, _, _ = jax.random.split(key, 4)
        noise.append(np.array(jax.random.normal(k_noise, shape)))
    return np.array(jax.random.normal(k_init, shape)), noise


@pytest.mark.parametrize("tiles", [False, True], ids=["untiled", "tiled"])
def test_superres_pipeline_matches_sd_tpu(tiles):
    """A 14² LR image upsampled 2x by the tiny f2 model, DDIM at eta 1 in
    4 DDIM steps (3 would make a grid of 4 at a stride of 333): untiled,
    and with the gate at 16 (LR patches of 8 at a stride of 4: a
    3 x 3 grid, its last row and column right-aligned)."""
    jldm, ldm = both("sr")
    gate = dict(tile_threshold=16, tile_ks=16, tile_stride=8) if tiles else {}
    jpipe = JaxSuperRes(ldm=jldm, up_f=2, vqf=2, **gate)
    pipe = SuperResPipeline(ldm=ldm, up_f=2, vqf=2, **gate)
    lr = (np.random.default_rng(15).uniform(0, 1, (14, 14, 3)) * 255).astype(np.uint8)
    steps, rng = 4, jax.random.PRNGKey(16)
    want_u8 = jpipe(lr, rng, steps=steps, eta=1.0)
    # sd_tpu's [-1, 1] output before its rounding: its cached programs called again
    cond, out_hw = jax_prepare_sr_cond(lr, 2)
    assert pipe.tiled(out_hw) == tiles
    sample = lambda c: jpipe._sample(jnp.asarray(c), rng, steps, 1.0)
    out = (jtiled.tiled_apply(sample, jnp.asarray(cond), ks=8, stride=4, out_scale=2) if tiles
           else sample(cond))
    want01 = np.clip((np.asarray(out) + 1.0) / 2.0, 0.0, 1.0)
    n = 9 if tiles else 1
    hw = 8 if tiles else 14
    x_T, noise = _ddim_draws(rng, steps, (n, hw, hw, 3))
    got_u8 = pipe(lr, steps=steps, eta=1.0, x_T=x_T, noise=noise)
    assert got_u8.shape == want_u8.shape == (1, 28, 28, 3) and got_u8.dtype == np.uint8
    assert pipe.last_latents.shape == (n, hw, hw, 3)
    np.testing.assert_allclose(pipe.last_output, want01, rtol=0, atol=1e-4)
    assert np.abs(got_u8.astype(int) - want_u8.astype(int)).max() <= 1
    assert set(pipe.last_timings) == {"sample_s", "decode_s", "total_s"}


def test_superres_draws_from_a_generator_and_the_bsr_config_builds():
    """Without given draws the pipeline draws from its generator: two calls
    with one seed agree, another seed differs. bsr_sr's config builds with
    its Identity cond stage, which get_learned_conditioning calls."""
    _, ldm = both("sr")
    pipe = SuperResPipeline(ldm=ldm, up_f=2, vqf=2)
    lr = (np.random.default_rng(17).uniform(0, 1, (8, 8, 3)) * 255).astype(np.uint8)
    run = lambda seed: pipe(lr, torch.Generator().manual_seed(seed), steps=2)
    a, b, c = run(0), run(0), run(1)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    x = torch.randn(1, 3, 4, 4)
    assert ldm.get_learned_conditioning(x) is x
