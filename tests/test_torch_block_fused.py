"""X1 and X2, the fused transformer-block kernels, on the CPU against the JAX
experiment they port (tools/exp_block_kernel.py) and sd_tpu's
BasicTransformerBlock.

The same numpy inputs (from a seed) go through both. The tool's kernels run
in Pallas interpret mode: the tool is loaded by path and its module-level
``pl`` is monkeypatched with a shim whose ``pallas_call`` adds
``interpret=True``; the tool itself is not edited. The port's wrappers
compute their plain versions on CPU tensors. Nothing in sd_tpu changes.

Tolerances (max abs difference over the reference's scale, max(1, max |ref|)):
- fp32 against the interpret-mode kernels and against xla_block: 1e-4, the
  order of the fp32 sums and X2's GELU (exact erf in the port, sd_tpu's
  polynomial with max error 5.5e-7 in the tool);
- bf16 against the interpret-mode kernels: 2e-2 (KERNEL_TOL): the same
  rounding points, where a 1-ulp difference of an fp32 sum can flip a bf16
  rounding of q, k, v, P, h or an output (2^-8 relative each);
- X2's two halves (the attention launches' plain function, then K2's plain
  version with the residual) against X2's plain version: bit for bit, in
  fp32 and bf16 (the same operations in the same order);
- X1∘X2 against sd_tpu's BasicTransformerBlock in fp32: 1e-4, the
  single-pass LayerNorm variance and the GELU polynomial;
- X1∘X2 against the port's block in bf16: relative L2 1e-2, chip_smoke.py's
  BLOCK_AGREEMENT_TOL; the experiment's check: its own AGREEMENT_TOL on the
  branch, which planted faults in the attention exceed;
- the argv grammar and the wrappers' checks: exact.
"""

import importlib
import math
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from sd_tpu.ops import attention as jattn
from sd_tpu_torch.ops.attention import BasicTransformerBlock
from sd_tpu_torch.ops.cuda import (block_weights, fused_block, fused_block_plain, geglu_ff_plain,
                                   tail_fused, tail_fused_plain)
from sd_tpu_torch.ops.cuda.fused_block import layer_norm_single_pass
from sd_tpu_torch.scripts import exp_block_kernel as exp
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.testing import load_numpy_state_dict, randomize_tree

port = importlib.import_module("sd_tpu_torch.ops.cuda.fused_block")

torch.backends.cuda.matmul.allow_tf32 = False

_TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / "exp_block_kernel.py"
FP32_TOL = 1e-4
KERNEL_TOL = 2e-2
BLOCK_TOL = 1e-4
BLOCK_AGREEMENT_TOL = 1e-2  # chip_smoke.py's, on the whole output


def _load_tool():
    spec = importlib.util.spec_from_file_location("exp_block_kernel_tool", _TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


tool = _load_tool()


class _InterpretPallas:
    """The tool's ``pl`` with every ``pallas_call`` in interpret mode."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, interpret=True, **kwargs)


@pytest.fixture
def jtool(monkeypatch):
    monkeypatch.setattr(tool, "pl", _InterpretPallas())
    return tool


def _np(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert np.isfinite(err) and err <= tol * scale, f"{what}: max abs error {err} > {tol * scale}"
    return err / scale


_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _as(dtype, x):
    """numpy x in the working type of both packages (bf16 rounded once)."""
    jx = jnp.asarray(x).astype(_DTYPES[dtype][0])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(_DTYPES[dtype][1])
    return jx, tx


def _block_args(seed, c):
    """X1's weights: γ, β, wq, wk, wv, wo ([in, out]), bo, fp32 numpy."""
    rng = np.random.default_rng(seed)
    return [1.0 + _np(rng, c, scale=0.1), _np(rng, c, scale=0.1),
            *(_np(rng, c, c, scale=c**-0.5) for _ in range(4)), _np(rng, c, scale=0.1)]


def _tail_args(seed, b, c, inner, nk, kv_len):
    """X2's arguments after x (kc, vc as numpy fp32, their padded rows
    non-zero, so that only the mask keeps them out)."""
    rng = np.random.default_rng(seed)
    kc, vc = _np(rng, b, nk, c), _np(rng, b, nk, c)
    assert np.abs(kc[:, kv_len:]).sum() > 0 or kv_len == nk
    return [1.0 + _np(rng, c, scale=0.1), _np(rng, c, scale=0.1),
            _np(rng, c, c, scale=c**-0.5), _np(rng, c, c, scale=c**-0.5),
            _np(rng, c, scale=0.1), kc, vc, 1.0 + _np(rng, c, scale=0.1), _np(rng, c, scale=0.1),
            _np(rng, c, 2 * inner, scale=c**-0.5), _np(rng, 2 * inner, scale=0.1),
            _np(rng, inner, c, scale=inner**-0.5), _np(rng, c, scale=0.1)]


def _jax_args(args, dtype, activations=()):
    """The JAX side: weights in fp32 (the tool casts them), the activation
    positions in the working type."""
    return [_as(dtype, a)[0] if i in activations else jnp.asarray(a) for i, a in enumerate(args)]


def _torch_args(args, dtype, activations=()):
    return [_as(dtype, a)[1] if i in activations else torch.from_numpy(a)
            for i, a in enumerate(args)]


# ------------------------------------------------------------------- X1


@pytest.mark.parametrize("dtype,b,n,heads,d,chunk", [
    ("float32", 2, 128, 2, 32, 64),
    ("bfloat16", 2, 128, 2, 32, 64),
    ("float32", 1, 64, 4, 20, 32),   # d not a multiple of 8 (plain version only)
    ("float32", 1, 64, 3, 24, 64),   # d a multiple of 8, not of 16 (padded in the kernel)
])
def test_fused_block_matches_the_pallas_kernel(jtool, dtype, b, n, heads, d, chunk):
    c = heads * d
    x = _np(np.random.default_rng(0), b, n, c)
    args = _block_args(1, c)
    jx, tx = _as(dtype, x)
    want = jtool.fused_block(jx, *map(jnp.asarray, args), heads, d, chunk=chunk)
    got = fused_block(tx, *map(torch.from_numpy, args), heads, d, chunk=chunk)
    assert got.dtype == tx.dtype
    _close(got.float(), want.astype(jnp.float32), FP32_TOL if dtype == "float32" else KERNEL_TOL,
           f"X1 {dtype}")


def test_fused_block_attends_over_every_key(jtool):
    """At N=96 with chunk 64 the JAX kernel drops the last 32 keys (its loop
    runs range(N // chunk)); the port attends over all 96 and matches the
    tool's xla_block, the function X1 stands for."""
    b, n, heads, d, chunk = 1, 96, 2, 16, 64
    c = heads * d
    x = _np(np.random.default_rng(2), b, n, c)
    args = _block_args(3, c)
    jargs = list(map(jnp.asarray, args))
    want = np.asarray(tool.xla_block(jnp.asarray(x), *jargs, heads, d))
    got = fused_block(torch.from_numpy(x), *map(torch.from_numpy, args), heads, d, chunk=chunk)
    _close(got, want, FP32_TOL, "X1 against xla_block")
    dropped = np.asarray(jtool.fused_block(jnp.asarray(x), *jargs, heads, d, chunk=chunk))
    assert np.abs(dropped - want).max() > 100 * FP32_TOL * max(1.0, np.abs(want).max())


# ------------------------------------------------------------------- X2


@pytest.mark.parametrize("dtype,b,n,heads,d,nk,kv_len,block_q", [
    ("float32", 2, 64, 2, 32, 16, 11, 64),
    ("bfloat16", 2, 64, 2, 32, 16, 11, 64),
    ("float32", 1, 32, 4, 20, 16, 16, 32),   # every row a key; d = 20
    # N = 40 against the port's row tiles (64, 128), the tool's block_q = N
    ("float32", 2, 40, 2, 16, 16, 11, 40),
    ("bfloat16", 2, 40, 2, 16, 16, 11, 40),
])
def test_tail_fused_matches_the_pallas_kernel(jtool, dtype, b, n, heads, d, nk, kv_len, block_q):
    """Non-zero padded K and V rows: the JAX kernel masks them, and so must
    the port; without the mask (kv_len = nk) the port's output moves far
    outside the bound."""
    c, inner = heads * d, 4 * heads * d
    x = _np(np.random.default_rng(4), b, n, c)
    args = _tail_args(5, b, c, inner, nk, kv_len)
    act = (5, 6)  # kc, vc in the working type, as the tool passes them
    jx, tx = _as(dtype, x)
    want = jtool.tail_fused(jx, *_jax_args(args, dtype, act), heads=heads, d=d, kv_len=kv_len,
                            block_q=block_q)
    targs = _torch_args(args, dtype, act)
    got = tail_fused(tx, *targs, heads, d, kv_len, block_q=block_q)
    tol = FP32_TOL if dtype == "float32" else KERNEL_TOL
    _close(got.float(), want.astype(jnp.float32), tol, f"X2 {dtype}")
    if kv_len < nk:
        unmasked = tail_fused(tx, *targs, heads, d, nk).float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        assert np.abs(unmasked - want).max() > 10 * tol * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tail_halves_compose_to_the_plain_version(dtype):
    """What X2's launches compute, half by half: the attention half (x1 and
    LN3(x1)), then K2's plain version with the residual mode on the weights
    as the kernels take them (out x in, value rows first), equals X2's plain
    version bit for bit."""
    b, n, heads, d, nk, kv_len = 2, 24, 2, 16, 16, 11
    c, inner = heads * d, 4 * heads * d
    x = _as(dtype, _np(np.random.default_rng(15), b, n, c))[1]
    g2, b2, wq, wo, bo, kc, vc, g3, b3, w1, b1, w2, bff = _torch_args(
        _tail_args(16, b, c, inner, nk, kv_len), dtype, (5, 6))
    x1, xln3 = port.tail_attention_plain(x, g2, b2, wq, wo, bo, kc, vc, g3, b3, heads, d, kv_len)
    dt = x.dtype
    got = geglu_ff_plain(xln3, w1.to(dt).t(), b1, w2.to(dt).t(), bff, residual=x1)
    want = tail_fused_plain(x, g2, b2, wq, wo, bo, kc, vc, g3, b3, w1, b1, w2, bff, heads, d,
                            kv_len)
    assert got.dtype == dt and xln3.dtype == dt
    assert torch.equal(got, want)
    assert not torch.equal(got, geglu_ff_plain(xln3, w1.to(dt).t(), b1, w2.to(dt).t(), bff,
                                               residual=x))


# ------------------------------------------------ the whole block, X1∘X2


@pytest.mark.parametrize("heads,d_head", [(2, 32), (4, 16)])
def test_x1_x2_match_sd_tpu_basic_transformer_block(heads, d_head):
    """The flax block's params go into the port's block through
    utils/convert.py and come back out through block_weights."""
    dim, ctx_dim = heads * d_head, 24
    rng = np.random.default_rng(6)
    x, ctx = _np(rng, 2, 64, dim), _np(rng, 2, 7, ctx_dim)
    module = jattn.BasicTransformerBlock(dim=dim, n_heads=heads, d_head=d_head,
                                         context_dim=ctx_dim)
    params = randomize_tree(module.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                        jnp.asarray(ctx))["params"], np.random.default_rng(7))
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx)))
    sd = {}
    convert._transformer_block(sd, params, "")
    block = load_numpy_state_dict(BasicTransformerBlock(dim, heads, d_head, context_dim=ctx_dim),
                                  sd)
    with torch.no_grad():
        got = exp.fused_transformer_block(block, torch.from_numpy(x), torch.from_numpy(ctx))
        unfused = block(torch.from_numpy(x), torch.from_numpy(ctx))
    _close(got, want, BLOCK_TOL, "X1∘X2 against sd_tpu")
    _close(unfused, want, BLOCK_TOL, "the port's block against sd_tpu")


def test_fused_transformer_block_bf16_agrees_with_the_unfused_block():
    """The smoke's agreement check, at a small size on the CPU: both in bf16,
    relative L2 within the smoke's bound (BLOCK_AGREEMENT_TOL)."""
    torch.manual_seed(0)
    block = BasicTransformerBlock(64, 2, 32, context_dim=48).eval()
    with torch.no_grad():
        for p in block.parameters():
            p.add_(0.05 * torch.randn_like(p))
    block = block.to(torch.bfloat16)
    x = torch.randn(2, 64, 64).to(torch.bfloat16)
    ctx = torch.randn(2, 77, 48).to(torch.bfloat16)
    with torch.no_grad():
        got = exp.fused_transformer_block(block, x, ctx)
        want = block(x, ctx)
    assert got.dtype == torch.bfloat16
    assert exp.relative_l2(got, want) <= BLOCK_AGREEMENT_TOL


def test_block_weights_layout():
    block = BasicTransformerBlock(64, 2, 32, context_dim=24).eval()
    ctx = torch.randn(3, 77, 24)
    x1, x2 = block_weights(block, ctx)
    assert (x1["heads"], x1["d"], x2["kv_len"]) == (2, 32, 77)
    assert torch.equal(x1["wq"], block.attn1.to_q.weight.t())
    assert torch.equal(x2["w1"], block.ff.net[0].proj.weight.t())
    assert x2["w1"].shape == (64, 512) and x2["w2"].shape == (256, 64)
    for name in ("kc", "vc"):
        assert x2[name].shape == (3, 80, 64)
        assert torch.count_nonzero(x2[name][:, 77:]) == 0
    assert torch.allclose(x2["kc"][:, :77], block.attn2.to_k(ctx))
    assert not any(t.requires_grad for t in (*x1.values(), *x2.values())
                   if isinstance(t, torch.Tensor))


def test_block_weights_refuses_another_layernorm_eps():
    block = BasicTransformerBlock(64, 2, 32, context_dim=24)
    block.norm2.eps = 1e-6
    with pytest.raises(ValueError):
        block_weights(block, torch.zeros(1, 7, 24))


# ------------------------------------------------- the plain pieces


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_single_pass_matches_the_tool(dtype):
    rng = np.random.default_rng(8)
    x = 3.0 + _np(rng, 4, 16, 96)
    gamma, beta = 1.0 + _np(rng, 96, scale=0.1), _np(rng, 96, scale=0.1)
    jx, tx = _as(dtype, x)
    want = tool._ln(jx, jnp.asarray(gamma), jnp.asarray(beta))
    got = layer_norm_single_pass(tx, torch.from_numpy(gamma), torch.from_numpy(beta))
    assert got.dtype == tx.dtype
    _close(got.float(), want.astype(jnp.float32), 1e-5 if dtype == "float32" else 1e-2, dtype)


def test_layer_norm_single_pass_constant_row_is_finite():
    """The clamp: a constant row can round E[x²] − mean² below 0."""
    x = torch.full((2, 3, 320), 7.123456)
    out = layer_norm_single_pass(x, torch.ones(320), torch.zeros(320))
    assert torch.isfinite(out).all()
    assert out.abs().max() < 1e-2


# -------------------------------------------------------- the wrappers


def test_wrappers_take_the_plain_version_on_the_cpu(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(port, "kernels", no_library)
    rng = np.random.default_rng(9)
    b, n, heads, d, nk, kv_len = 2, 16, 2, 8, 16, 5
    c = heads * d
    x = torch.from_numpy(_np(rng, b, n, c)).to(torch.bfloat16)
    a1 = list(map(torch.from_numpy, _block_args(10, c)))
    a2 = list(map(torch.from_numpy, _tail_args(11, b, c, 4 * c, nk, kv_len)))
    launches = (fused_block.launches, tail_fused.launches)
    assert torch.equal(fused_block(x, *a1, heads, d), fused_block_plain(x, *a1, heads, d))
    assert torch.equal(tail_fused(x, *a2, heads, d, kv_len),
                       tail_fused_plain(x, *a2, heads, d, kv_len))
    assert (fused_block.launches, tail_fused.launches) == launches


def test_wrappers_are_forward_only():
    c, heads, d = 16, 2, 8
    x = torch.randn(1, 8, c, requires_grad=True)
    a1 = list(map(torch.from_numpy, _block_args(12, c)))
    a2 = list(map(torch.from_numpy, _tail_args(13, 1, c, 4 * c, 8, 8)))
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_block(x, *a1, heads, d)
    with pytest.raises(RuntimeError, match="forward-only"):
        tail_fused(x, *a2, heads, d, 8)
    a1[3].requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_block(x.detach(), *a1, heads, d)
    with torch.no_grad():
        assert fused_block(x, *a1, heads, d).shape == x.shape
        assert tail_fused(x, *a2, heads, d, 8).shape == x.shape


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no path"):
        fused_block(x, *[torch.zeros(s, device="meta") for s in
                         ((16,), (16,), (16, 16), (16, 16), (16, 16), (16, 16), (16,))], 2, 8)


def _checked_tail(**change):
    b, n, heads, d, nk, kv_len, inner = 2, 8, 2, 16, 16, 11, 128
    c = heads * d
    args = dict(x=torch.zeros(b, n, c, dtype=torch.bfloat16), g2=torch.zeros(c),
                b2=torch.zeros(c), wq=torch.zeros(c, c), wo=torch.zeros(c, c), bo=torch.zeros(c),
                kc=torch.zeros(b, nk, c, dtype=torch.bfloat16),
                vc=torch.zeros(b, nk, c, dtype=torch.bfloat16), g3=torch.zeros(c),
                b3=torch.zeros(c), w1=torch.zeros(c, 2 * inner), b1=torch.zeros(2 * inner),
                w2=torch.zeros(inner, c), bff=torch.zeros(c), heads=heads, d=d, kv_len=kv_len)
    args.update(change)
    port._check_tail(**args)


@pytest.mark.parametrize("change,error", [
    ({}, None),
    ({"x": torch.zeros(2, 8, 32)}, TypeError),                       # fp32 on the card
    ({"kc": torch.zeros(2, 16, 32)}, TypeError),
    ({"heads": 4, "d": 8}, None),
    ({"heads": 2, "d": 12}, ValueError),                             # C != heads · d
    ({"x": torch.zeros(2, 8, 40, dtype=torch.bfloat16), "heads": 2, "d": 20}, ValueError),
    ({"kv_len": 17}, ValueError),                                    # kv_len > nk
    ({"kv_len": 0}, ValueError),
    ({"w1": torch.zeros(32, 200)}, ValueError),                      # not 2 · inner
    ({"w2": torch.zeros(100, 32), "w1": torch.zeros(32, 200),
      "b1": torch.zeros(200)}, ValueError),                          # inner % 8
    ({"vc": torch.zeros(2, 12, 32, dtype=torch.bfloat16)}, ValueError),
    ({"bo": torch.zeros(31)}, ValueError),
])
def test_tail_fused_checks(change, error):
    """The checks a CUDA call meets before its launch, run on CPU tensors."""
    if error is None:
        _checked_tail(**change)
    else:
        with pytest.raises(error):
            _checked_tail(**change)


@pytest.mark.parametrize("heads,d,error", [
    (8, 160, None), (8, 168, ValueError),   # d past the attention launches' 160
    (12, 128, ValueError),                  # C past their 1280
])
def test_tail_fused_takes_what_the_attention_launches_take(heads, d, error):
    """X2's attention half runs on X1's launches, so it takes their head dim
    and row width (a row's LayerNorm in a warp); inner is K2's."""
    c, inner = heads * d, 16
    vec = torch.zeros(c)
    kv = torch.zeros(1, 8, c, dtype=torch.bfloat16)
    args = (torch.zeros(1, 4, c, dtype=torch.bfloat16), vec, vec, torch.zeros(c, c),
            torch.zeros(c, c), vec, kv, kv, vec, vec, torch.zeros(c, 2 * inner),
            torch.zeros(2 * inner), torch.zeros(inner, c), vec, heads, d, 8)
    if error is None:
        port._check_tail(*args)
    else:
        with pytest.raises(error, match="attention launches"):
            port._check_tail(*args)


@pytest.mark.parametrize("c,heads,d,error", [
    (64, 2, 32, None), (48, 2, 24, None), (40, 2, 20, ValueError), (64, 4, 32, ValueError),
    (1280, 8, 160, None), (1344, 8, 168, ValueError),   # d past the kernels' 160
    (1536, 12, 128, ValueError),                        # C past the kernels' 1280
])
def test_fused_block_checks(c, heads, d, error):
    x = torch.zeros(2, 8, c, dtype=torch.bfloat16)
    vec, mat = torch.zeros(c), torch.zeros(c, c)
    args = (x, vec, vec, mat, mat, mat, mat, vec, heads, d)
    if error is None:
        port._check_block(*args)
        with pytest.raises(TypeError):
            port._check_block(x.float(), *args[1:])
        with pytest.raises(ValueError):
            port._check_block(x, vec, vec, mat, mat, torch.zeros(c, c + 8), mat, vec, heads, d)
    else:
        with pytest.raises(error):
            port._check_block(*args)


# ------------------------------------------------------ the experiment


@pytest.mark.parametrize("argv", [[], ["256"], ["1024", "640"], ["tail"], ["tail", "64"],
                                  ["tail", "256", "1280"]])
def test_argv_grammar_matches_the_tool(argv, monkeypatch):
    """The tool's own __main__ dispatch, stopped at its first random draw
    (x0 of shape (B, N, C)); main splits its key 8 ways, main_tail 12."""

    class Stop(Exception):
        pass

    splits = []
    real_split = jax.random.split
    monkeypatch.setattr(jax.random, "split",
                        lambda key, num=2: splits.append(num) or real_split(key, num))

    def stop(key, shape, *args, **kwargs):
        raise Stop(shape)

    monkeypatch.setattr(jax.random, "normal", stop)
    monkeypatch.setattr(sys, "argv", ["exp_block_kernel.py", *argv])
    with pytest.raises(Stop) as info:
        runpy.run_path(str(_TOOL), run_name="__main__")
    b, n, c = info.value.args[0]
    mode = {8: "block", 12: "tail"}[splits[0]]
    assert exp.parse_args(argv) == (mode, n, c)
    assert b == exp.B


@pytest.mark.parametrize("mode", ["block", "tail"])
def test_experiment_checks_fused_against_unfused_on_the_cpu(mode):
    x0, step_fused, _, result = exp.check(mode, 32, 64, device="cpu")
    assert x0.shape == (exp.B, 32, 64) and x0.dtype == torch.bfloat16
    assert result["relative_l2"] <= exp.AGREEMENT_TOL
    assert torch.equal(step_fused(x0), step_fused(x0))


def test_experiment_times_only_on_the_card():
    with pytest.raises(RuntimeError, match="card"):
        exp.time_chain(lambda x: x, torch.zeros(2))


def _dropping(attend):
    """``_attend`` over the first three quarters of its keys only."""
    def attend_fewer(q, k, v, kv_len):
        keep = 3 * min(kv_len, k.shape[1]) // 4
        return attend(q, k[:, :keep], v[:, :keep], keep)
    return attend_fewer


_FAULTS = {
    "a key dropped of every four": _dropping,
    "another head's V": lambda attend: lambda q, k, v, kv_len: attend(q, k, v.roll(1, dims=2),
                                                                     kv_len),
    "the attention left out": lambda attend: lambda q, k, v, kv_len: torch.zeros_like(
        attend(q, k, v, kv_len)),
    "the mask left out": lambda attend: lambda q, k, v, kv_len: attend(q, k, v, k.shape[1]),
}


@pytest.mark.parametrize("mode,fault", [
    ("block", "a key dropped of every four"), ("block", "another head's V"),
    ("block", "the attention left out"), ("tail", "a key dropped of every four"),
    ("tail", "another head's V"), ("tail", "the mask left out")])
def test_experiment_check_catches_faults_in_the_attention(mode, fault, monkeypatch):
    """The experiment's check compares what each step adds to x0, so a fault
    in the fused step's attention fails it, however small the attention's
    share of the output (the plain version, which the wrappers compute on
    the CPU, with the fault planted in its attention)."""
    monkeypatch.setattr(port, "_attend", _FAULTS[fault](port._attend))
    with pytest.raises(AssertionError, match="relative L2"):
        exp.check(mode, 128, 64, device="cpu")


@pytest.mark.parametrize("wrapper", ["fused_block", "tail_fused"])
def test_tile_size_arguments_change_nothing(wrapper):
    """``chunk`` and ``block_q`` are the TPU kernels' tile sizes, taken for
    the tool's signature: the port attends over every key and writes every
    row whatever they are."""
    mode, keyword = {"fused_block": ("block", "chunk"), "tail_fused": ("tail", "block_q")}[wrapper]
    x0, step, _, _ = exp.check(mode, 96, 64, device="cpu")
    fn = {"fused_block": fused_block, "tail_fused": tail_fused}[wrapper]
    args = (exp.block_inputs if mode == "block" else exp.tail_inputs)(96, 64, "cpu")[1]
    want = step(x0)
    for tile in (16, 64, 4096):
        assert torch.equal(fn(x0, **args, **{keyword: tile}), want)


def test_x1_weights_are_the_transposed_sources_kept_per_version():
    """X1's prepared weights: [Wq' | Wk | Wv]ᵀ and Woᵀ in the working type,
    kept while the sources are the same tensors at the same versions, made
    again after an in-place edit or for another tensor."""
    port._weight_cache.clear()
    rng = np.random.default_rng(14)
    c, d = 32, 16
    wq, wk, wv, wo = (torch.from_numpy(_np(rng, c, c)) for _ in range(4))
    wqkv, wo_t = port.x1_weights(wq, wk, wv, wo, d, torch.bfloat16)
    scaled = (wq * (d**-0.5 * math.log2(math.e))).to(torch.bfloat16)
    assert torch.equal(wqkv, torch.cat([scaled, wk.to(torch.bfloat16),
                                        wv.to(torch.bfloat16)], dim=1).t())
    assert torch.equal(wo_t, wo.to(torch.bfloat16).t()) and wo_t.is_contiguous()
    assert port.x1_weights(wq, wk, wv, wo, d, torch.bfloat16)[0] is wqkv   # kept
    with torch.no_grad():
        wk.mul_(2.0)
    again = port.x1_weights(wq, wk, wv, wo, d, torch.bfloat16)
    assert again[0] is not wqkv
    assert torch.equal(again[0][c:2 * c], wk.to(torch.bfloat16).t())
    wo2 = wo.clone()
    assert torch.equal(port.x1_weights(wq, wk, wv, wo2, d, torch.bfloat16)[1],
                       wo2.to(torch.bfloat16).t())
    assert port.x1_weights(wq, wk, wv, wo, d, torch.float32)[0].dtype == torch.float32
    port._weight_cache.clear()
