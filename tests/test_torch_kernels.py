"""The port's kernel modules on the CPU: each plain version against the Pallas
kernel it replaces, run in interpret mode as tests/test_flash_attention.py and
tests/test_geglu_ff.py run it, and the wrappers' CPU dispatch. The CUDA
kernels themselves run only on the card: chip_smoke.py holds them against
these plain versions there.

Tolerances: flash 2e-5 absolute (an fp32 softmax summed in another order);
the FF adds the Pallas fp32 path's two-piece erf error (5.5e-7 before the
output projection).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sd_tpu.ops.attention import _xla_attention
from sd_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
from sd_tpu.ops.pallas.geglu_ff import geglu_ff as pallas_geglu_ff
from sd_tpu_torch.ops.cuda import _build
from sd_tpu_torch.ops.cuda import flash_attention, flash_attention_plain, geglu_ff, geglu_ff_plain

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
    assert {p.name for p in _build._sources()[0]} == {"flash_attention.cu", "geglu_ff.cu"}


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("q,k,error", [
    (torch.zeros((1, 64, 2, 16)), _bf16(1, 64, 2, 16), TypeError),   # fp32 on the card path
    (_bf16(1, 64, 2, 16), _bf16(1, 64, 2, 24), ValueError),          # head dims differ
    (_bf16(1, 64, 2, 20), _bf16(1, 64, 2, 20), ValueError),          # d not a multiple of 8
    (_bf16(1, 64, 1, 520), _bf16(1, 64, 1, 520), ValueError),        # d above 512
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


def test_wrappers_accept_the_path_shapes():
    importlib.import_module("sd_tpu_torch.ops.cuda.flash_attention")._check_inputs(
        _bf16(2, 64, 8, 40), _bf16(2, 64, 8, 40), _bf16(2, 64, 8, 40))
    importlib.import_module("sd_tpu_torch.ops.cuda.geglu_ff")._check_inputs(
        _bf16(2, 64, 320), _bf16(2560, 320), torch.zeros(2560), _bf16(320, 1280),
        torch.zeros(320))
