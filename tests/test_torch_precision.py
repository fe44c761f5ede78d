"""The port's dispatch around K1 and K2 on the CPU: FeedForward's dropout
against sd_tpu's, the dtype rule that sends the card's non-bf16 calls to the
plain versions, SD_TPU_PRECISION in the pipeline builder, the plain versions
against sd_tpu's Pallas kernels (interpret mode) at sharp logits, and the
planted faults of ``sd_tpu_torch.scripts.flash_faults`` against the sources.

Tolerances: FeedForward 1e-5 (fp32, the same products summed in another
order); dropout at rate 1.0 is exact (both packages zero every element);
the attention plain versions as in tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.ops import attention as jattn
from sd_tpu.ops.pallas.flash_attention import _bwd_bhnd_pallas
from sd_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
from sd_tpu_torch.ops import attention as attn
from sd_tpu_torch.ops.cuda import (flash_attention_bwd_plain, flash_attention_plain, geglu_ff,
                                   geglu_ff_plain)
from sd_tpu_torch.pipelines import build
from sd_tpu_torch.scripts import flash_faults
from sd_tpu_torch.utils.testing import load_numpy_state_dict, randomize_tree

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DIM = 16


def _ff_pair(dropout: float, seed: int = 0):
    """sd_tpu's gated FeedForward and the port's with the same weights, and x."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, DIM)).astype(np.float32)
    module = jattn.FeedForward(DIM, glu=True, dropout=dropout)
    params = randomize_tree(module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    port = attn.FeedForward(DIM, dropout=dropout)
    load_numpy_state_dict(port, {
        "net.0.proj.weight": np.asarray(params["proj_in"]["proj"]["kernel"]).T,
        "net.0.proj.bias": params["proj_in"]["proj"]["bias"],
        "net.2.weight": np.asarray(params["proj_out"]["kernel"]).T,
        "net.2.bias": params["proj_out"]["bias"]})
    return module, params, port, x


def _refuse(*args, **kwargs):
    raise AssertionError("a kernel wrapper was entered")


def test_feedforward_eval_matches_sd_tpu_with_dropout():
    module, params, port, x = _ff_pair(0.5)
    want = module.apply({"params": params}, jnp.asarray(x), deterministic=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_feedforward_training_at_dropout_one_gives_the_output_bias():
    """flax's Dropout(rate=1.0) zeros everything, and so does the port's: both
    give net[2]'s bias exactly."""
    module, params, port, x = _ff_pair(1.0)
    bias = np.broadcast_to(np.asarray(params["proj_out"]["bias"]), x.shape)
    want = module.apply({"params": params}, jnp.asarray(x), deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(1)})
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(want), bias)
    np.testing.assert_array_equal(got.numpy(), bias)


def test_feedforward_training_with_dropout_skips_the_kernel(monkeypatch):
    _, _, port, x = _ff_pair(0.5)
    x = torch.from_numpy(x)
    with torch.no_grad():
        evaluated = port.eval()(x)
        monkeypatch.setattr(attn, "differentiable_geglu_ff", _refuse)
        monkeypatch.setattr(attn, "geglu_ff_int8", _refuse)
        before = geglu_ff.launches
        torch.manual_seed(0)
        trained = port.train()(x)
    assert geglu_ff.launches == before
    assert not torch.allclose(trained, evaluated)


def test_feedforward_training_without_dropout_takes_the_kernel(monkeypatch):
    _, _, port, x = _ff_pair(0.0)
    calls = []

    def wrapper(*args):
        calls.append(args)
        return geglu_ff_plain(*args)

    monkeypatch.setattr(attn, "differentiable_geglu_ff", wrapper)
    with torch.no_grad():
        port.train()(torch.from_numpy(x))
    assert len(calls) == 1


@pytest.mark.parametrize("device_type,dtype,want", [
    ("cuda", torch.bfloat16, True),    # the kernels
    ("cuda", torch.float32, False),    # an fp32 model on the card: the plain versions
    ("cuda", torch.float16, False),
    ("cpu", torch.float32, True),      # the wrappers' plain versions
    ("cpu", torch.bfloat16, True),
])
def test_takes_kernel(device_type, dtype, want):
    assert attn.takes_kernel(device_type, dtype) is want


def test_kernel_dtype_follows_autocast():
    x = torch.zeros(2, 8)
    assert attn._kernel_dtype(x) == torch.float32
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert attn._kernel_dtype(x) == torch.bfloat16


def _card_in_fp32(monkeypatch):
    """The dispatch of an fp32 tensor on the card, on CPU tensors: the rule
    answers as it does for ("cuda", float32), and every wrapper refuses."""
    monkeypatch.setattr(attn, "takes_kernel", lambda device_type, dtype: False)
    for name in ("differentiable_flash_attention", "flash_attention_int8",
                 "differentiable_geglu_ff", "geglu_ff_int8"):
        monkeypatch.setattr(attn, name, _refuse)


def test_attention_off_the_kernel_dtype_takes_the_plain_version(monkeypatch):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 2, 16)).astype(np.float32))
               for _ in range(3))
    _card_in_fp32(monkeypatch)
    got = attn.dot_product_attention(q, k, v)
    assert torch.equal(got, flash_attention_plain(q, k, v, 16 ** -0.5))


def test_feedforward_off_the_kernel_dtype_takes_the_plain_version(monkeypatch):
    module, params, port, x = _ff_pair(0.0)
    _card_in_fp32(monkeypatch)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    want = module.apply({"params": params}, jnp.asarray(x), deterministic=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("env,precision,device,want", [
    (None, None, "cuda", torch.bfloat16),
    ("fp32", None, "cuda", torch.float32),
    ("FLOAT32", None, "cuda", torch.float32),
    ("bf16", None, "cuda", torch.bfloat16),
    ("bf16", "fp32", "cuda", torch.float32),   # the argument over the variable
    ("fp32", "bf16", "cuda", torch.bfloat16),
    (None, None, "cpu", torch.float32),
])
def test_inference_dtype(monkeypatch, env, precision, device, want):
    """sd_tpu's inference_compute_dtype: fp32 where SD_TPU_PRECISION says
    fp32 or float32, else bf16; the CPU is fp32."""
    if env is None:
        monkeypatch.delenv("SD_TPU_PRECISION", raising=False)
    else:
        monkeypatch.setenv("SD_TPU_PRECISION", env)
    assert build.inference_dtype(device, precision) == want


class _Built(Exception):
    pass


@pytest.mark.parametrize("env,precision,want", [
    ("fp32", None, torch.float32), ("fp32", "bf16", torch.bfloat16), (None, None, torch.bfloat16)])
def test_builder_reads_sd_tpu_precision(monkeypatch, env, precision, want):
    """build_txt2img_pipeline hands the model builder the dtype the variable
    (or its argument) asks for on the card."""
    if env is None:
        monkeypatch.delenv("SD_TPU_PRECISION", raising=False)
    else:
        monkeypatch.setenv("SD_TPU_PRECISION", env)

    def built(cfg, *, dtype, **kwargs):
        raise _Built(dtype)

    monkeypatch.setattr(build, "build_latent_diffusion", built)
    with pytest.raises(_Built) as caught:
        build.build_txt2img_pipeline(tiny=True, device="cuda", precision=precision)
    assert caught.value.args[0] == want


def test_flash_plain_matches_pallas_at_sharp_logits():
    """q scaled by 4, as chip_smoke.py's sharp runs: the plain version that
    holds K1 on the card still agrees with the TPU kernel."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 256, 2, 40)).astype(np.float32) for _ in range(3))
    q *= 4.0
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                        block_q=128, kv_chunk=128)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_flash_bwd_plain_matches_pallas_at_sharp_logits():
    shape = (1, 512, 2, 16)
    rng = np.random.default_rng(3)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    q *= 4.0
    scale = shape[-1] ** -0.5
    o = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    bhnd = lambda a: jnp.asarray(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
    want = _bwd_bhnd_pallas(*(bhnd(a) for a in (q, k, v, o, do)), scale, shape[1],
                            interpret=True)
    got = flash_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, o, do)), scale)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("name", list(flash_faults.FAULTS))
def test_planted_fault_applies_to_the_sources(tmp_path, name):
    """Each fault of the planted-fault check matches the sources as often as
    it expects, and changes them: a kernel edit that moved the text would
    otherwise turn the check into a run of the sound kernels."""
    csrc = flash_faults.ROOT / "sd_tpu_torch" / "csrc"
    _, edits = flash_faults.FAULTS[name]
    for source in {edit[0] for edit in edits}:
        (tmp_path / source).write_text((csrc / source).read_text())
    flash_faults.plant(tmp_path, edits)
    for source in {edit[0] for edit in edits}:
        assert (tmp_path / source).read_text() != (csrc / source).read_text()
    with pytest.raises(RuntimeError, match="expected"):
        flash_faults.plant(tmp_path, edits)
