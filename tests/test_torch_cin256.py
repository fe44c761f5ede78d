"""cin256-v2 in the port against sd_tpu on the CPU, and the attention
route that lets its one-head sites run on the card.

- :func:`sd_tpu_torch.ops.attention.attention_route` at each case: K1 up to
  its head dim of 1024 (cin256-v2's d = 960 at N = 64 included, which
  sd_tpu leaves to XLA), the plain route above it where sd_tpu's
  ``flash_supported`` shape rule leaves the site to XLA, a ValueError
  naming ROADMAP.md's coverage item where sd_tpu runs its kernel; the
  shape rule against sd_tpu's own predicate (its platform check patched to
  a TPU); K5's and K3's caps of 512.
- A tiny single-head spatial-transformer UNet with a ClassEmbedder (head
  dims 64 and 96, cin256-v2's layout at narrow width) against sd_tpu's from
  the same parameters: rtol and atol 1e-4 of the output's scale, fp32.
- cin256-v2 and bsr_sr at full width on the meta device: their UNets'
  parameter counts equal to sd_tpu's (over ``jax.eval_shape``).
"""

import functools
import importlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.ops.pallas import flash_attention as jax_flash
from sd_tpu.utils import config as jconfig
from sd_tpu_torch.ops import attention as port_attention
from sd_tpu_torch.ops.attention import attention_route, dot_product_attention
from sd_tpu_torch.utils.config import (build_latent_diffusion, load_yaml,
                                       tiny_class_cond_model_config)
from sd_tpu_torch.utils.testing import load_numpy_state_dict
from torch_parity import jax_ldm, ldm_state_dict, nchw, to_nhwc, torch_threads

# the module, which the package's flash_attention function shadows
port_flash = importlib.import_module("sd_tpu_torch.ops.cuda.flash_attention")
torch.backends.cuda.matmul.allow_tf32 = False
BF16 = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


# (device type, dtype, B, Nq, Nk, H, d) -> the route
ROUTES = {
    "cin256 d=384 N=1024": (("cuda", BF16, 8, 1024, 1024, 1, 384), "K1"),
    "cin256 d=576 N=256": (("cuda", BF16, 8, 256, 256, 1, 576), "K1"),
    "cin256 d=960 N=64": (("cuda", BF16, 8, 64, 64, 1, 960), "K1"),
    "d=960 off sd_tpu's row rule (N=200)": (("cuda", BF16, 2, 200, 200, 1, 960), "K1"),
    "d=960 above sd_tpu's 4096 rows": (("cuda", BF16, 1, 8192, 8192, 1, 960), "K1"),
    "d=1032 N=64": (("cuda", BF16, 8, 64, 64, 1, 1032), "plain"),
    "d=1032 off sd_tpu's row rule (N=200)": (("cuda", BF16, 2, 200, 200, 1, 1032), "plain"),
    "d=1032 above sd_tpu's 4096 rows": (("cuda", BF16, 1, 8192, 8192, 1, 1032), "plain"),
    "VAE mid-block d=512": (("cuda", BF16, 1, 4096, 4096, 1, 512), "K1"),
    "cross-attention d=960": (("cuda", BF16, 8, 256, 1, 1, 960), "plain"),
    "fp32 on the card": (("cuda", torch.float32, 8, 256, 256, 1, 576), "plain"),
    "CPU d=576": (("cpu", torch.float32, 8, 256, 256, 1, 576), "K1"),
    "CPU d=960 N=64": (("cpu", torch.float32, 8, 64, 64, 1, 960), "K1"),
    "CPU d=1032 N=64": (("cpu", torch.float32, 8, 64, 64, 1, 1032), "plain"),
    "d=640 N=256, where sd_tpu runs its kernel": (("cuda", BF16, 8, 256, 256, 1, 640), "K1"),
    "CPU d=1024 N=4096": (("cpu", torch.float32, 1, 4096, 4096, 1, 1024), "K1"),
    "d=1032 N=256, where sd_tpu runs its kernel": (("cuda", BF16, 8, 256, 256, 1, 1032), None),
    "CPU d=1032 N=4096": (("cpu", torch.float32, 1, 4096, 4096, 1, 1032), None),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_attention_route(case):
    args, want = ROUTES[case]
    if want is None:
        with pytest.raises(ValueError, match="K1 above d = 1024"):
            attention_route(*args)
    else:
        assert attention_route(*args) == want


def test_flash_shape_rule_is_sd_tpus(monkeypatch):
    """The port's shape rule against sd_tpu's flash_supported, its platform
    check answered as on a TPU, at every head dim it is asked."""
    monkeypatch.setattr(jax_flash.jax, "devices", lambda *a: [types.SimpleNamespace(
        platform="tpu")])
    for nq, nk in ((64, 64), (100, 100), (128, 128), (200, 200), (256, 256), (1024, 1024),
                   (4096, 4096), (8192, 8192), (256, 77), (1024, 256)):
        q = jax.ShapeDtypeStruct((1, nq, 1, 960), jnp.float32)
        k = jax.ShapeDtypeStruct((1, nk, 1, 960), jnp.float32)
        assert port_flash.flash_shape_supported(nq, nk) == jax_flash.flash_supported(q, k, k)


def test_the_caps_of_k5_and_k3():
    """K5 and K3 stop at 512 where K1 goes on to 1024: K5's padding and its
    mode send a wider head to bf16 K1; K3's rule refuses where sd_tpu runs
    its backward kernel and takes the plain backward where sd_tpu does."""
    assert port_flash.K1_MAX_HEAD_DIM == 1024
    assert port_flash.K3_MAX_HEAD_DIM == port_flash.K5_MAX_HEAD_DIM == 512
    assert [port_flash.int8_padded_dim(d) for d in (40, 512, 520, 576)] == [48, 512, 0, 0]
    q = torch.zeros(1, 2048, 1, 576)
    assert port_flash.resolve_int8("qkpv", q, q) == "off"
    q = torch.zeros(1, 2048, 1, 512)
    assert port_flash.resolve_int8("qkpv", q, q) == "qkpv"
    assert port_flash.uses_bwd_kernel(1024, 1024, 384) and port_flash.uses_bwd_kernel(
        4096, 4096, 512)
    assert not port_flash.uses_bwd_kernel(256, 256, 576)   # cin256-v2's d = 576 site
    assert not port_flash.uses_bwd_kernel(64, 64, 960)
    with pytest.raises(ValueError, match="K3 above d = 512"):
        port_flash.uses_bwd_kernel(1024, 1024, 576)


def test_dot_product_attention_takes_each_route_on_the_cpu(monkeypatch):
    """On CPU tensors: d = 1032 at N = 64 goes to the plain version (not the
    kernel wrapper), d = 576 at N = 256 and d = 960 at N = 64 to the
    wrapper, and d = 1032 at N = 256 is refused."""
    calls = []
    monkeypatch.setattr(port_attention, "differentiable_flash_attention",
                        lambda *a: calls.append("K1") or port_flash.flash_attention_plain(*a))
    rng = np.random.default_rng(0)
    for n, d, want in ((64, 1032, []), (256, 576, ["K1"]), (64, 960, ["K1"])):
        q, k, v = (torch.from_numpy(rng.standard_normal((2, n, 1, d)).astype(np.float32))
                   for _ in range(3))
        calls.clear()
        out = dot_product_attention(q, k, v)
        assert calls == want
        torch.testing.assert_close(out, port_flash.flash_attention_plain(q, k, v), rtol=0,
                                   atol=0)
    q = torch.zeros(1, 256, 1, 1032)
    with pytest.raises(ValueError, match="K1 above d = 1024"):
        dot_product_attention(q, q, q)


def tiny_cin_config():
    """cin256-v2's layout at narrow width: one head, a spatial transformer
    with a ClassEmbedder context, attention at the 2x and 4x levels (head
    dims 64 and 96), none at the first."""
    cfg = tiny_class_cond_model_config(n_classes=11)
    cfg["params"]["unet_config"]["params"].update(
        model_channels=32, channel_mult=[1, 2, 3], attention_resolutions=[4, 2], num_heads=1)
    return cfg


@functools.lru_cache(maxsize=None)
def tiny_cin():
    cfg = tiny_cin_config()
    jldm = jax_ldm(cfg, np.random.default_rng(3))
    ldm = load_numpy_state_dict(build_latent_diffusion(cfg, device="cpu"),
                                ldm_state_dict(cfg, jldm))
    return jldm, ldm


def test_single_head_class_conditional_unet_matches_sd_tpu():
    jldm, ldm = tiny_cin()
    heads = {m.heads for m in ldm.modules() if type(m).__name__ == "CrossAttention"}
    dims = {m.dim_head for m in ldm.modules() if type(m).__name__ == "CrossAttention"}
    assert heads == {1} and dims == {64, 96}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 16, 16, 4)).astype(np.float32)
    t = np.array([3, 500, 999], np.int32)
    ids = np.array([0, 7, 10], np.int32)  # 10: the last id, the unconditional one

    def run(p, x, t, ids):
        m = jldm.bind_params(p)
        return m.apply_model(x, t, m.get_learned_conditioning(ids))

    want = np.asarray(jax.jit(run)(jldm.runtime_params(), x, t, ids))
    with torch.no_grad():
        cond = ldm.get_learned_conditioning(torch.from_numpy(ids))
        got = ldm.apply_model(nchw(x), torch.from_numpy(t).long(), cond)
    assert cond.shape == (3, 1, 32)
    np.testing.assert_allclose(to_nhwc(got), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name, x_channels", [("cin256-v2", 3), ("bsr_sr", 6)])
def test_full_width_unet_parameter_counts_equal_sd_tpus(name, x_channels):
    from pathlib import Path

    cfg = load_yaml(str(Path(__file__).resolve().parents[1] / "sd_tpu_torch" / "configs" /
                        f"{name}.yaml"))["model"]
    ldm = build_latent_diffusion(cfg, device="meta")
    unet_cfg = cfg["params"]["unet_config"]
    junet = jconfig.instantiate_from_config(unet_cfg)
    ctx = unet_cfg["params"].get("context_dim")
    args = (jnp.zeros((1, 64, 64, x_channels)), jnp.zeros((1,), jnp.int32),
            None if ctx is None else jnp.zeros((1, 1, ctx)))
    shapes = jax.eval_shape(lambda: junet.init(jax.random.PRNGKey(0), *args)["params"])
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    got = sum(p.numel() for p in ldm.model.diffusion_model.parameters())
    assert got == want
    if name == "cin256-v2":
        assert 400e6 < got < 402e6
        assert ldm.cond_stage_model.embedding.num_embeddings == 1001
        dims = sorted({m.dim_head for m in ldm.modules()
                       if type(m).__name__ == "CrossAttention"})
        assert dims == [384, 576, 960]
    else:
        assert ldm.conditioning_key == "concat" and ldm.cond_stage_key == "LR_image"
        assert isinstance(ldm.cond_stage_model, torch.nn.Identity)
