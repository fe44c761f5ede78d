"""The port's kernel modules on the CPU: each plain version against the Pallas
kernel it replaces, run in interpret mode as tests/test_flash_attention.py and
tests/test_geglu_ff.py run it, and the wrappers' CPU dispatch. The CUDA
kernels themselves run only on the card: chip_smoke.py holds them against
these plain versions there.

Tolerances: flash 2e-5 absolute (an fp32 softmax summed in another order);
the FF adds the Pallas fp32 path's two-piece erf error (5.5e-7 before the
output projection). The backward (K3's plain version and the differentiable
entry points) 1e-5 of the gradient's scale: fp32 products of the same
operands, summed in another order.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.ops.attention import _xla_attention
from sd_tpu.ops.pallas.flash_attention import _bwd_bhnd_pallas, _bwd_bhnd_xla
from sd_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
from sd_tpu.ops.pallas.geglu_ff import _split_reference
from sd_tpu.ops.pallas.geglu_ff import geglu_ff as pallas_geglu_ff
from sd_tpu_torch.ops.cuda import _build
from sd_tpu_torch.ops.cuda import (differentiable_flash_attention, differentiable_geglu_ff,
                                   flash_attention, flash_attention_bwd,
                                   flash_attention_bwd_plain, flash_attention_lse_plain,
                                   flash_attention_plain, geglu_ff, geglu_ff_plain)
from sd_tpu_torch.ops.cuda.flash_attention import uses_bwd_kernel

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,kv_chunk", [
    ((2, 256, 2, 40), None),   # the d=40 head dim of the UNet's N=4096 sites
    ((1, 128, 1, 64), None),
    ((1, 256, 2, 80), 128),    # the online-softmax (chunked) TPU kernel
])
def test_flash_plain_matches_pallas(shape, kv_chunk):
    q, k, v = _qkv(shape, 0)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                        block_q=128, kv_chunk=kv_chunk)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_flash_plain_matches_xla_at_n64():
    """N=64 (the UNet's 8x8 mid-block) is below the Pallas kernel's 128-row
    tiling; sd_tpu sends it to _xla_attention, the port to K1."""
    shape = (2, 64, 8, 16)
    q, k, v = _qkv(shape, 1)
    d = shape[-1]
    want = _xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d**-0.5, None)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("m,c,inner", [(256, 64, 256), (128, 32, 128)])
def test_geglu_plain_matches_pallas(m, c, inner):
    rng = np.random.default_rng(2)
    x = (0.5 * rng.standard_normal((m, c))).astype(np.float32)
    w1 = (0.05 * rng.standard_normal((c, 2 * inner))).astype(np.float32)   # sd_tpu: [C, 2I]
    b1 = (0.1 * rng.standard_normal(2 * inner)).astype(np.float32)
    w2 = (0.05 * rng.standard_normal((inner, c))).astype(np.float32)      # sd_tpu: [I, C]
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    want = pallas_geglu_ff(*map(jnp.asarray, (x, w1, b1, w2, b2)), interpret=True, block_m=128)
    # the port takes torch Linear layout: w1 [2I, C], w2 [C, I]
    got = geglu_ff_plain(torch.from_numpy(x), torch.from_numpy(w1.T.copy()),
                         torch.from_numpy(b1), torch.from_numpy(w2.T.copy()),
                         torch.from_numpy(b2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    q, k, v = map(torch.from_numpy, _qkv((1, 64, 2, 16), 3))
    rng = np.random.default_rng(4)
    x, w1, b1, w2, b2 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                         for s in ((3, 5, 16), (64, 16), (64,), (16, 32), (16,)))
    before = flash_attention.launches, geglu_ff.launches
    assert torch.equal(flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert torch.equal(geglu_ff(x, w1, b1, w2, b2), geglu_ff_plain(x, w1, b1, w2, b2))
    assert (flash_attention.launches, geglu_ff.launches) == before


def test_wrappers_refuse_devices_without_a_path():
    q = torch.empty((1, 64, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no path"):
        flash_attention(q, q, q)
    x = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="no path"):
        geglu_ff(x, torch.empty((64, 16), device="meta"), torch.empty(64, device="meta"),
                 torch.empty((16, 32), device="meta"), torch.empty(16, device="meta"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_library_name_is_keyed_to_the_sources():
    path = _build._library_path()
    assert path.parent == _build._BUILD_DIR
    assert path.name.startswith("libsd_tpu_kernels-") and path.suffix == ".so"
    assert path == _build._library_path()
    cu, headers = _build._sources()
    assert {p.name for p in cu} == {"flash_attention.cu", "flash_attention_bwd.cu",
                                    "geglu_ff.cu", "flash_attention_int8.cu",
                                    "geglu_ff_int8.cu", "int8_dense.cu", "fused_conv.cu",
                                    "winograd_conv.cu", "fused_block.cu", "tail_fused.cu"}
    assert {p.name for p in headers} == {"flash_mma.cuh", "fused_block.cuh", "geglu_ff.cuh",
                                         "int8_wgmma.cuh", "tma.cuh"}


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("q,k,error", [
    (torch.zeros((1, 64, 2, 16)), _bf16(1, 64, 2, 16), TypeError),   # fp32 on the card path
    (_bf16(1, 64, 2, 16), _bf16(1, 64, 2, 24), ValueError),          # head dims differ
    (_bf16(1, 64, 2, 20), _bf16(1, 64, 2, 20), ValueError),          # d not a multiple of 8
    (_bf16(1, 64, 1, 1032), _bf16(1, 64, 1, 1032), ValueError),      # d above 1024
    (_bf16(1, 64, 2, 16), _bf16(2, 64, 2, 16), ValueError),          # batches differ
])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(q, k, error):
    """The checks a CUDA tensor meets before the launch, run on CPU tensors."""
    module = importlib.import_module("sd_tpu_torch.ops.cuda.flash_attention")
    with pytest.raises(error):
        module._check_inputs(q, k, k)


@pytest.mark.parametrize("x,w1,error", [
    (torch.zeros((4, 16), dtype=torch.float16), _bf16(64, 16), TypeError),
    (_bf16(4, 16), _bf16(64, 8), ValueError),    # w1 is not [2 * inner, C]
    (_bf16(4, 12), _bf16(64, 12), ValueError),   # C not a multiple of 8
])
def test_geglu_wrapper_rejects_what_the_kernel_does_not_take(x, w1, error):
    module = importlib.import_module("sd_tpu_torch.ops.cuda.geglu_ff")
    with pytest.raises(error):
        module._check_inputs(x, w1, torch.zeros(64), _bf16(x.shape[-1], 32),
                             torch.zeros(x.shape[-1]))


# SD v1's FF sites (M, C, inner = 4C) at batch 1, 4 (training) and 8, and a
# ragged M: K2 takes every one
_SD_V1_FF = [(b * n, c, 4 * c) for b in (2, 4, 16)
             for n, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))] + [(1000, 320, 1280)]


@pytest.mark.parametrize("m,c,inner", _SD_V1_FF)
def test_geglu_wrapper_takes_every_sd_v1_ff_shape(m, c, inner):
    meta = lambda *s, dtype=torch.bfloat16: torch.empty(s, dtype=dtype, device="meta")
    importlib.import_module("sd_tpu_torch.ops.cuda.geglu_ff")._check_inputs(
        meta(m, c), meta(2 * inner, c), meta(2 * inner, dtype=torch.float32), meta(c, inner),
        meta(c, dtype=torch.float32))


@pytest.mark.parametrize("w2_shape,error", [
    ((16, 36), ValueError),   # inner not a multiple of 8 (w1 is [2 * inner, C] to match)
    ((12, 32), ValueError),   # C_out not a multiple of 8
])
def test_geglu_wrapper_rejects_ragged_widths(w2_shape, error):
    module = importlib.import_module("sd_tpu_torch.ops.cuda.geglu_ff")
    c_out, inner = w2_shape
    with pytest.raises(error):
        module._check_inputs(_bf16(4, 16), _bf16(2 * inner, 16), torch.zeros(2 * inner),
                             _bf16(c_out, inner), torch.zeros(c_out))


def test_wrappers_accept_the_path_shapes():
    importlib.import_module("sd_tpu_torch.ops.cuda.flash_attention")._check_inputs(
        _bf16(2, 64, 8, 40), _bf16(2, 64, 8, 40), _bf16(2, 64, 8, 40))
    importlib.import_module("sd_tpu_torch.ops.cuda.geglu_ff")._check_inputs(
        _bf16(2, 64, 320), _bf16(2560, 320), torch.zeros(2560), _bf16(320, 1280),
        torch.zeros(320))


# ------------------------------------------------------------------ backward


def _close_to_scale(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def _t(x):
    """[B, N, H, D] numpy -> sd_tpu's [B, H, N, D] kernel layout."""
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("shape,reference", [
    ((1, 512, 2, 16), "pallas"),   # K3's branch: Nk > 256, Nq % 256 == 0
    ((1, 256, 2, 16), "xla"),      # the plain branch
    ((1, 512, 1, 512), "pallas"),  # K3's branch at the VAE mid-block's head dim
])
def test_flash_bwd_plain_matches_sd_tpu(shape, reference):
    q, k, v = _qkv(shape, 5)
    do = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    scale = shape[-1] ** -0.5
    o = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    args = [_t(a) for a in (q, k, v, o, do)]
    if reference == "pallas":
        want = _bwd_bhnd_pallas(*args, scale, shape[1], interpret=True)
    else:
        want = _bwd_bhnd_xla(*args, scale, shape[1])
    got = flash_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, o, do)), scale)
    for g, w in zip(got, want):
        _close_to_scale(g.numpy(), np.asarray(w).transpose(0, 2, 1, 3))


@pytest.mark.parametrize("n", [512, 256])
def test_differentiable_attention_grads_match_jax(n):
    """jax.grad of sd_tpu's flash_attention (Pallas in interpret mode) against
    the port's autograd function, on each branch of the backward dispatch."""
    shape = (2, n, 2, 16)
    q, k, v = _qkv(shape, 7)
    w = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    assert uses_bwd_kernel(n, n, shape[-1]) == (n > 256)

    def loss(q_, k_, v_):
        return jnp.sum(jnp.asarray(w) * pallas_flash(q_, k_, v_, interpret=True, block_q=128))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = differentiable_flash_attention(*leaves)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for leaf, g in zip(leaves, want):
        _close_to_scale(leaf.grad.numpy(), g)


def test_differentiable_geglu_grads_match_jax_vjp():
    """The port's K2 autograd function against jax.vjp of sd_tpu's
    _split_reference, the backward of its fused kernel."""
    rng = np.random.default_rng(9)
    m, c, inner = 64, 32, 128
    x = (0.5 * rng.standard_normal((m, c))).astype(np.float32)
    w1a, w1g = ((0.1 * rng.standard_normal((c, inner))).astype(np.float32) for _ in range(2))
    b1a, b1g = ((0.1 * rng.standard_normal(inner)).astype(np.float32) for _ in range(2))
    w2 = (0.1 * rng.standard_normal((inner, c))).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    dy = rng.standard_normal((m, c)).astype(np.float32)
    _, vjp = jax.vjp(_split_reference, *map(jnp.asarray, (x, w1a, w1g, b1a, b1g, w2, b2)))
    dx, dw1a, dw1g, db1a, db1g, dw2, db2 = vjp(jnp.asarray(dy))

    # torch Linear layout: w1 [2I, C] value rows first, w2 [C, I]
    leaves = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in
              (x, np.concatenate([w1a.T, w1g.T]), np.concatenate([b1a, b1g]), w2.T, b2)]
    y = differentiable_geglu_ff(*leaves)
    assert y.grad_fn is not None
    y.backward(torch.from_numpy(dy))
    want = [dx, np.concatenate([np.asarray(dw1a).T, np.asarray(dw1g).T]),
            np.concatenate([db1a, db1g]), np.asarray(dw2).T, db2]
    for leaf, w in zip(leaves, want):
        _close_to_scale(leaf.grad.numpy(), w)


def test_lse_plain_is_the_log2_softmax_normalizer():
    q, k, _ = map(torch.from_numpy, _qkv((1, 64, 2, 16), 10))
    lse = flash_attention_lse_plain(q, k, 0.25)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.25
    p = torch.exp2(logits * np.log2(np.e) - lse[..., None])
    torch.testing.assert_close(p.sum(-1), torch.ones_like(lse), rtol=0, atol=1e-5)


def test_cpu_backward_takes_the_plain_version_and_counts_nothing():
    q, k, v = map(torch.from_numpy, _qkv((1, 512, 2, 16), 11))
    o = flash_attention_plain(q, k, v, 0.25)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, o, None, 0.25)
    for g, w in zip(got, flash_attention_bwd_plain(q, k, v, o, o, 0.25)):
        assert torch.equal(g, w)
    assert flash_attention_bwd.launches == before


def test_no_grad_calls_take_the_inference_wrappers():
    q = torch.zeros((1, 64, 2, 16), requires_grad=True)
    with torch.no_grad():
        assert differentiable_flash_attention(q, q, q).grad_fn is None
    x = torch.zeros((4, 16))
    assert differentiable_geglu_ff(x, torch.zeros((64, 16)), torch.zeros(64),
                                   torch.zeros((16, 32)), torch.zeros(16)).grad_fn is None


def test_no_grad_feedforward_under_autocast_takes_the_autocast_dtype():
    """fp32 master weights evaluated under no_grad and autocast (the
    trainer's validation and image logging): the inference wrapper gets
    inputs in autocast's dtype, as the autograd function's do."""
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((4, 16), (64, 16), (64,), (16, 32), (16,))]
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = differentiable_geglu_ff(*args)
    want = geglu_ff_plain(*(a.to(torch.bfloat16) for a in args))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("d,lse_shape,error", [
    (520, (1, 2, 64), ValueError),   # K3 takes d up to 512
    (40, (1, 2, 32), ValueError),    # lse is not [B, H, Nq]
    (40, None, ValueError),          # no lse
])
def test_flash_bwd_wrapper_rejects_what_the_kernel_does_not_take(d, lse_shape, error):
    module = importlib.import_module("sd_tpu_torch.ops.cuda.flash_attention")
    t = _bf16(1, 64, 2, d)
    lse = None if lse_shape is None else torch.zeros(lse_shape)
    with pytest.raises(error):
        module._check_bwd_inputs(t, t, t, t, t, lse)


def test_flash_bwd_wrapper_accepts_the_path_shapes():
    module = importlib.import_module("sd_tpu_torch.ops.cuda.flash_attention")
    # the UNet's training sites, and the VAE mid-block's at 256² and 512²
    for b, n, h, d in ((4, 4096, 8, 40), (4, 1024, 8, 80), (12, 1024, 1, 512),
                       (2, 4096, 1, 512), (1, 64, 1, 136)):
        t = _bf16(b, n, h, d)
        module._check_bwd_inputs(t, t, t, t, t, torch.zeros((b, h, n)))
