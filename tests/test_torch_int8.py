"""The port's int8 serving mode on the CPU, against sd_tpu's.

The same numpy inputs (from a seed) go into both packages. sd_tpu reaches its
int8 paths on the CPU only through monkeypatching, as its own tests do
(tests/test_wq_hoist.py, tests/test_int8_dense.py): its bucket gate is
patched to ignore the backend and dtype, its Pallas kernels run in interpret
mode, and SD_TPU_FLASH_FORCE=interpret sends self-attention to the flash
kernel. The port's gate is patched to ignore the device and dtype in the same
way, so its int8 sites run their plain versions on fp32 CPU tensors.
Nothing in sd_tpu changes.

Tolerances:
- quantization (codes and scales, inline and at load time): bit for bit;
- the plain versions of the int8 conv, K4, K5 and K6 on identical inputs:
  1e-5 of the output's scale: the integer products are exact in both, and
  only the fp32 dequant, GELU and softmax are summed or contracted in
  another order;
- modules and the tiny UNet slice: their int8 sites quantize activations
  that come out of earlier layers, which agree only to fp32 rounding, so a
  code can land one step away where a value sits on a rounding boundary;
  each test bounds the relative L2 difference and checks that the int8
  effect itself (int8 against fp32 in the port) is at least ten times it.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.ops import attention as jattn
from sd_tpu.ops import conv as jconv
from sd_tpu.ops import quant as jquant
from sd_tpu.ops.pallas import geglu_ff as jff
from sd_tpu.ops.pallas import int8_dense as jdense
from sd_tpu.ops.pallas.flash_attention import _resolve_int8 as jax_resolve_int8
from sd_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
from sd_tpu.models.unet import UNetConfig as JaxUNetConfig
from sd_tpu.models.unet import UNetModel as JaxUNet
from sd_tpu_torch.models.unet import UNetConfig, UNetModel
from sd_tpu_torch.ops import quant
from sd_tpu_torch.ops.attention import (CrossAttention, FeedForward, VAEAttnBlock,
                                        dot_product_attention)
from sd_tpu_torch.ops.conv import Conv3x3
from sd_tpu_torch.ops.cuda import (flash_attention_int8, flash_attention_int8_plain,
                                   flash_attention_plain, geglu_ff_int8, geglu_ff_int8_plain,
                                   int8_dense, int8_dense_plain, resolve_int8)
from sd_tpu_torch.ops.cuda.geglu_ff import (gelu_fast, int8_ff_supported, quantize_cols,
                                            quantize_ff_weights)
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.testing import load_numpy_state_dict, randomize_tree
from torch_parity import torch_threads

# the modules: the package exports functions of the same names
port_ff = importlib.import_module("sd_tpu_torch.ops.cuda.geglu_ff")
port_flash = importlib.import_module("sd_tpu_torch.ops.cuda.flash_attention")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


KERNEL_TOL = 1e-5
MODULE_TOL = 2e-3
ALL = ("conv", "ff", "attn", "attn_pv", "proj")


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _close(got, want, tol=KERNEL_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


def _rows(x):
    return int(np.prod(x.shape[:-1]))


@pytest.fixture
def int8_on(monkeypatch):
    """Open both packages' int8 gates on the CPU for the given buckets."""

    def on(buckets=ALL):
        buckets = frozenset(buckets)
        monkeypatch.delenv("SD_TPU_INT8", raising=False)
        monkeypatch.setenv("SD_TPU_FLASH_FORCE", "interpret")
        monkeypatch.setattr(jquant, "int8_bucket_enabled", lambda b, dtype: b in buckets)
        # the fused FF's row rule without its platform check
        monkeypatch.setattr(jff, "ff_supported",
                            lambda x, inner: _rows(x) >= 1024 and _rows(x) % 256 == 0)
        real_ff, real_dense = jff.geglu_ff, jdense.int8_dense
        monkeypatch.setattr(jff, "geglu_ff", lambda *a, **k: real_ff(*a, **k, interpret=True))
        monkeypatch.setattr(jdense, "int8_dense",
                            lambda *a, **k: real_dense(*a, **k, interpret=True))
        monkeypatch.setattr(quant, "int8_device_ok", lambda x: True)
        return quant.Int8Mode(buckets)

    return on


# ------------------------------------------------------------ quantization


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_rows_bitwise(axis):
    x = _np(0, (64, 48), 3.0)
    x[3] = 0.0  # an all-zero row: the scale floor
    x[5, :4] = [127.5 / 127 * 2, -2.0, 1.0, 0.5]  # near-ties
    jq, js = jquant.quantize_rows(jnp.asarray(x), axis=axis)
    q, s = quant.quantize_rows(torch.from_numpy(x), dim=axis)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_quantize_conv_kernel_bitwise():
    k = _np(1, (3, 3, 16, 24), 0.1)  # HWIO
    jkq, jsw = jquant.quantize_conv_kernel(jnp.asarray(k))
    kq, sw = quant.quantize_conv_kernel(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
    np.testing.assert_array_equal(kq.numpy().transpose(2, 3, 1, 0), np.asarray(jkq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))


def test_quantize_cols_bitwise():
    w = _np(2, (64, 96), 0.05)  # sd_tpu's [in, out]
    jq, js = jff._quantize_cols(jnp.asarray(w))
    q, s = quantize_cols(torch.from_numpy(w.T.copy()))  # torch Linear [out, in]
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js).reshape(-1))


def test_load_time_weights_match_sd_tpu_overlay():
    """FeedForward's and Conv3x3's load-time int8 weights against sd_tpu's
    prequantize_weights overlay on the same parameters, bit for bit, and
    against the inline quantization."""
    c, inner = 32, 128
    params = {"ff": {"proj_in": {"proj": {"kernel": _np(3, (c, 2 * inner), 0.1),
                                          "bias": _np(4, (2 * inner,))}},
                     "proj_out": {"kernel": _np(5, (inner, c), 0.1), "bias": _np(6, (c,))}},
              "conv": {"kernel": _np(7, (3, 3, 8, 16), 0.1), "bias": _np(8, (16,))}}
    qw = jquant.prequantize_weights(params, compute_dtype=jnp.float32)

    ff = FeedForward(c)
    ff.net[0].proj.weight.data = torch.from_numpy(params["ff"]["proj_in"]["proj"]["kernel"].T.copy())
    ff.net[2].weight.data = torch.from_numpy(params["ff"]["proj_out"]["kernel"].T.copy())
    got = ff.int8_weights()
    for name in ("w1a", "w1g", "w2"):
        np.testing.assert_array_equal(got[f"{name}_q"].numpy().T, np.asarray(qw["ff"][f"{name}_q"]))
        np.testing.assert_array_equal(got[f"{name}_s"].numpy(),
                                      np.asarray(qw["ff"][f"{name}_s"]).reshape(-1))
    inline = quantize_ff_weights(ff.net[0].proj.weight, ff.net[2].weight, torch.float32)
    assert all(torch.equal(got[k], inline[k]) for k in inline)

    conv = Conv3x3(8, 16)
    conv.weight.data = torch.from_numpy(params["conv"]["kernel"].transpose(3, 2, 0, 1).copy())
    got = conv.int8_weights()
    np.testing.assert_array_equal(got["kq"].numpy().transpose(2, 3, 1, 0),
                                  np.asarray(qw["conv"]["kq"]))
    np.testing.assert_array_equal(got["sw"].numpy(), np.asarray(qw["conv"]["sw"]))


def test_load_time_weights_follow_replaced_weights():
    """Weights replaced after load-time quantization (in place, by
    load_state_dict, or by a cast) are quantized again, never served stale."""
    conv = Conv3x3(8, 16)
    first = conv.int8_weights()
    assert conv.int8_weights() is first  # cached
    with torch.no_grad():
        conv.weight.mul_(2.0)
    second = conv.int8_weights()
    assert second is not first and torch.equal(second["sw"], 2.0 * first["sw"])
    sd = {k: torch.randn_like(v) for k, v in conv.state_dict().items()}
    conv.load_state_dict(sd)
    assert torch.equal(conv.int8_weights()["kq"], quant.quantize_conv_kernel(sd["weight"])[0])
    conv.to(torch.bfloat16)
    want = quant.quantize_conv_kernel(conv.weight)
    assert torch.equal(conv.int8_weights()["kq"], want[0])


def test_interleaved_ff_weight_deinterleaves_to_the_halves():
    """K4's first weight from quantize_ff_weights: W1a's and W1g's rows in
    alternating runs of 64, codes and scales, which de-interleave bit for
    bit to the halves'; and FeedForward's load-time copy follows a replaced
    weight."""
    c, inner = 32, 256
    w1 = torch.from_numpy(_np(30, (2 * inner, c), 0.1))
    w2 = torch.from_numpy(_np(31, (c, inner), 0.1))
    qw = quantize_ff_weights(w1, w2, torch.float32)
    run = 64
    codes = qw["w1_q"].view(inner // run, 2, run, c)
    scales = qw["w1_s"].view(inner // run, 2, run)
    assert torch.equal(codes[:, 0].reshape(inner, c), qw["w1a_q"])
    assert torch.equal(codes[:, 1].reshape(inner, c), qw["w1g_q"])
    assert torch.equal(scales[:, 0].reshape(inner), qw["w1a_s"])
    assert torch.equal(scales[:, 1].reshape(inner), qw["w1g_s"])
    # rows 128 u + j are the value rows 64 u + j, rows 128 u + 64 + j the gate's
    assert torch.equal(qw["w1_q"][128 + 5], qw["w1a_q"][64 + 5])
    assert torch.equal(qw["w1_q"][128 + 64 + 5], qw["w1g_q"][64 + 5])
    ff = FeedForward(c, mult=inner // c)
    first = ff.int8_weights()["w1_q"]
    with torch.no_grad():
        ff.net[0].proj.weight[inner:].mul_(-1.0)
    second = ff.int8_weights()
    assert torch.equal(second["w1_q"].view(inner // run, 2, run, c)[:, 0],
                       first.view(inner // run, 2, run, c)[:, 0])
    assert torch.equal(second["w1_q"].view(inner // run, 2, run, c)[:, 1],
                       -first.view(inner // run, 2, run, c)[:, 1])


@pytest.mark.parametrize("c,inner,c_out,ok", [
    (640, 2560, 640, True), (1280, 5120, 1280, True), (320, 1280, 320, True),
    (1312, 5248, 1312, False),   # C past 1280: a block keeps its rows of x quantized
    (336, 1280, 336, False),     # C % 32
    (640, 2624, 640, False),     # inner % 128: the output GEMM's k blocks
])
def test_geglu_int8_wrapper_checks(c, inner, c_out, ok):
    """The checks a CUDA tensor meets before K4's launch, run on CPU tensors."""
    x = torch.zeros((256, c), dtype=torch.bfloat16)
    qw = {"w1a_q": torch.zeros((inner, c), dtype=torch.int8),
          "w1g_q": torch.zeros((inner, c), dtype=torch.int8), "w1a_s": torch.ones(inner),
          "w1g_s": torch.ones(inner), "w2_q": torch.zeros((c_out, inner), dtype=torch.int8),
          "w2_s": torch.ones(c_out), "w1_q": torch.zeros((2 * inner, c), dtype=torch.int8),
          "w1_s": torch.ones(2 * inner)}
    b1, b2 = torch.zeros(2 * inner), torch.zeros(c_out)
    if ok:
        port_ff._check_int8_inputs(x, qw, b1, b2)
    else:
        with pytest.raises(ValueError):
            port_ff._check_int8_inputs(x, qw, b1, b2)
    with pytest.raises(TypeError):
        port_ff._check_int8_inputs(x.float(), qw, b1, b2)
    if ok:  # a weight dict without the interleaved first weight
        with pytest.raises(ValueError):
            port_ff._check_int8_inputs(x, {k: v for k, v in qw.items() if k != "w1_q"}, b1, b2)


def test_gelu_fast_matches_sd_tpu():
    g = np.linspace(-6.0, 6.0, 4097, dtype=np.float32)
    _close(gelu_fast(torch.from_numpy(g)).numpy(), np.asarray(jff._gelu_fast_f32(jnp.asarray(g))))


# ------------------------------------------------------- the conv and kernels


def test_int8_conv_plain_matches_sd_tpu():
    x = _np(10, (2, 12, 12, 16))  # NHWC, one activation scale over the batch
    x[1] *= 3.0
    k = _np(11, (3, 3, 16, 24), 0.1)
    b = _np(12, (24,), 0.1)
    want = jquant.int8_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), jnp.float32)
    with torch.no_grad():
        got = quant.int8_conv3x3(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                                 torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                                 torch.from_numpy(b))
    _close(got.numpy().transpose(0, 2, 3, 1), np.asarray(want))
    # the int8 effect is visible against the fp32 conv
    ref = torch.nn.functional.conv2d(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                                     torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                                     torch.from_numpy(b), padding=1)
    assert 1e-4 < _rel(got, ref) < 2e-2


@pytest.mark.parametrize("cin,cout", [(4, 3), (16, 24)])  # K = 36 and N = 3 padded to 8
def test_int8_conv_card_layout_matches_plain(monkeypatch, cin, cout):
    """The card's im2col + torch._int_mm path (torch._int_mm also runs on
    the CPU) against the float64 plain conv on the same codes, with the
    im2col cut into one image per chunk."""
    x = torch.from_numpy(_np(13, (3, cin, 9, 7)))
    w = torch.from_numpy(_np(14, (cout, cin, 3, 3), 0.2))
    b = torch.from_numpy(_np(15, (cout,), 0.1))
    xq, sx = quant._quantize_tensor(x)
    kq, sw = quant.quantize_conv_kernel(w)
    monkeypatch.setattr(quant, "_IM2COL_CHUNK_BYTES", 9 * 7 * 9 * cin)
    got = quant._int8_conv_card(xq, sx, kq, sw, b, torch.float32)
    want = quant.int8_conv3x3_plain(xq, sx, kq, sw, b, torch.float32)
    _close(got.numpy(), want.numpy())


def test_int8_conv_zero_input_no_nan():
    with torch.no_grad():
        out = quant.int8_conv3x3(torch.zeros(1, 16, 8, 8), torch.zeros(16, 16, 3, 3),
                                 torch.ones(16))
    assert torch.isfinite(out).all() and torch.allclose(out, torch.ones_like(out))


@pytest.mark.parametrize("m,c,inner", [(256, 64, 256), (512, 32, 128)])
def test_geglu_int8_plain_matches_pallas(m, c, inner):
    x = _np(20, (m, c), 0.5)
    w1 = _np(21, (c, 2 * inner), 0.1)  # sd_tpu: [C, 2I]
    b1 = _np(22, (2 * inner,), 0.1)
    w2 = _np(23, (inner, c), 0.1)      # sd_tpu: [I, C]
    b2 = _np(24, (c,), 0.1)
    want = jff.geglu_ff(*map(jnp.asarray, (x, w1, b1, w2, b2)), interpret=True, int8=True,
                        block_m=128)
    got = geglu_ff_int8(*map(torch.from_numpy, (x, w1.T.copy(), b1, w2.T.copy(), b2)))
    _close(got.numpy(), np.asarray(want))
    assert _rel(got, port_ff.geglu_ff_plain(*map(torch.from_numpy, (
        x, w1.T.copy(), b1, w2.T.copy(), b2)))) > 1e-4  # int8 engaged


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_flash_int8_plain_matches_pallas_two_chunks(mode):
    """N=2048 is two 1024-key chunks; below 2048 keys sd_tpu turns int8 off
    (its own test at N=1024 compares the bf16 kernel with itself)."""
    shape = (1, 2048, 2, 40)
    q, k, v = (_np(30 + i, shape) for i in range(3))
    want = pallas_flash(*map(jnp.asarray, (q, k, v)), interpret=True, int8=mode)
    want_off = pallas_flash(*map(jnp.asarray, (q, k, v)), interpret=True, int8="off")
    assert np.abs(np.asarray(want) - np.asarray(want_off)).max() > 1e-4  # engaged
    got = flash_attention_int8(*map(torch.from_numpy, (q, k, v)), mode=mode)
    if mode == "qk":
        _close(got.numpy(), np.asarray(want))
    else:
        # P's codes round(p * 127) come from exp2, which the two libraries
        # round differently in the last place: a code on a rounding boundary
        # may land one step away, moving its row's output by at most
        # max|V| / 127 / l. Almost every element agrees to KERNEL_TOL.
        err = np.abs(got.numpy() - np.asarray(want))
        scale = np.abs(np.asarray(want)).max()
        assert err.max() < 2e-3 * scale and np.mean(err > KERNEL_TOL * scale) < 1e-2
    plain = flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    assert (got - plain).abs().max() > 1e-4


def test_flash_int8_qk_single_softmax_equals_chunks():
    """In "qk" the chunking is exact up to rounding: one full softmax of the
    same int8 logits agrees with the chunked plain version."""
    shape = (1, 2048, 1, 16)
    q, k, v = (torch.from_numpy(_np(40 + i, shape)) for i in range(3))
    got = flash_attention_int8_plain(q, k, v, 0.25, "qk")
    qq, sq = quant.quantize_rows(q)
    kq, sk = quant.quantize_rows(k)
    logits = torch.einsum("bqhd,bkhd->bhqk", qq.float(), kq.float())
    logits = logits * sq.permute(0, 2, 1, 3) * 0.25 * sk.permute(0, 2, 3, 1)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
    _close(got.numpy(), want.numpy())


def _smoke_constants():
    """chip_smoke.py's bounds, which hold K5 on the card."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_flash_int8_qk_one_pass_rounding_within_bound():
    """K5's "qk" runs one pass with a running max per 64-key tile, so it
    rounds P to bf16 against that max where the chunked plain version (and
    sd_tpu's kernel) round it against the max after each 1024-key chunk.
    Written out here on the same int8 logits, with sharp logits (q times
    chip_smoke's SHARP) so that the running max moves within chunks, the
    difference stays within chip_smoke's INT8_TOL["K5 qk"] of the output's
    scale, against both."""
    smoke = _smoke_constants()
    tol = smoke.INT8_TOL["K5 qk"]
    shape = (1, 2048, 2, 40)
    q, k, v = (_np(70 + i, shape) for i in range(3))
    q = q * smoke.SHARP
    scale = shape[-1] ** -0.5
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    plain = flash_attention_int8_plain(qt, kt, vt, scale, "qk").numpy()
    want = np.asarray(pallas_flash(*map(jnp.asarray, (q, k, v)), interpret=True, int8="qk"))

    qq, sq = quant.quantize_rows(qt.transpose(1, 2))
    kq, sk = quant.quantize_rows(kt.transpose(1, 2))
    logits = (quant.int8_matmul_exact(qq, kq.transpose(-1, -2))
              * (sq * (scale * np.log2(np.e))) * sk.transpose(-1, -2))
    vh = vt.transpose(1, 2)
    m = torch.full(sq.shape, -np.inf)
    l = torch.zeros(sq.shape)
    acc = torch.zeros(vh.shape)
    for k0 in range(0, shape[1], 64):
        s = logits[..., k0:k0 + 64]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vh[..., k0:k0 + 64, :]
        m = m_new
    one_pass = (acc / l).transpose(1, 2).numpy()
    for ref in (plain, want):
        err = np.abs(one_pass - ref).max()
        assert 0 < err <= tol * np.abs(ref).max()


@pytest.mark.parametrize("q_shape,k_shape,why", [
    ((1, 1536, 1, 40), (1, 1536, 1, 40), "N not a multiple of the 1024-key chunk"),
    ((1, 2048, 1, 40), (1, 1024, 1, 40), "cross-attention"),
    ((1, 2048, 1, 12), (1, 2048, 1, 12), "d not a multiple of 8"),
    ((1, 2048, 1, 520), (1, 3072, 1, 520), "N of q and k differ at d = 520"),
])
def test_flash_int8_wrapper_rejects_what_the_kernel_does_not_take(q_shape, k_shape, why):
    """The checks a CUDA tensor meets before K5 launches, run on CPU tensors."""
    bf = lambda s: torch.zeros(s, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        port_flash._check_int8_inputs(bf(q_shape), bf(k_shape), bf(k_shape))


def test_flash_int8_padded_dims_and_scratch_shapes():
    """d pads to 48 up to 48, to 512 up to 512 and to a multiple of 512
    above; "qkpv"'s V codes are transposed, [B, H, DP, N], with per-chunk
    scales [B, H, N / 1024, DP]."""
    assert [port_flash.int8_padded_dim(d) for d in (8, 40, 48, 56, 512, 520, 44, 1280)] == [
        48, 48, 48, 512, 512, 1024, 48, 1536]
    bf = lambda s: torch.zeros(s, dtype=torch.bfloat16)
    assert port_flash._check_int8_inputs(*(bf((2, 4096, 8, 40)),) * 3) == 48
    assert port_flash._check_int8_inputs(*(bf((1, 4096, 1, 512)),) * 3) == 512
    qk = port_flash.int8_scratch_shapes(2, 4096, 8, 40, "qk")
    assert qk == {"qq": (2, 8, 4096, 48), "sq": (2, 8, 4096), "kq": (2, 8, 4096, 48),
                  "sk": (2, 8, 4096)}
    pv = port_flash.int8_scratch_shapes(1, 4096, 1, 512, "qkpv")
    assert pv["vq"] == (1, 1, 512, 4096) and pv["sv"] == (1, 1, 4, 512)
    assert {k: pv[k] for k in qk} == {"qq": (1, 1, 4096, 512), "sq": (1, 1, 4096),
                                      "kq": (1, 1, 4096, 512), "sk": (1, 1, 4096)}


@pytest.mark.parametrize("m,c,f,bias", [(256, 64, 192, False), (512, 128, 128, True),
                                        (260, 64, 96, True)])  # 260 rows: no block, plain
def test_int8_dense_plain_matches_pallas(m, c, f, bias):
    x = _np(50, (m, c), 0.5)
    w = _np(51, (c, f), 0.05)  # sd_tpu: [C, F]
    b = _np(52, (f,), 0.1) if bias else None
    want = jdense.int8_dense(jnp.asarray(x), jnp.asarray(w),
                             None if b is None else jnp.asarray(b), interpret=True)
    got = int8_dense(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                     None if b is None else torch.from_numpy(b))
    _close(got.numpy(), np.asarray(want))


def test_int8_dense_without_bias_matches_pallas_at_a_proj_site():
    """K6's wrapper with b=None (the fused QKV call) against sd_tpu's
    int8_dense in interpret mode, at the proj bucket's narrowest widths."""
    x = _np(53, (2, 64, 320), 0.5)
    w = _np(54, (320, 960), 0.05)  # sd_tpu: [C, F]
    want = jdense.int8_dense(jnp.asarray(x), jnp.asarray(w), None, interpret=True)
    wq, sw = quantize_cols(torch.from_numpy(w.T.copy()))
    got = int8_dense(torch.from_numpy(x), None, prequant=(wq, sw))
    assert got.shape == (2, 64, 960)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("c,f,ok", [(320, 960, True), (1280, 1280, True), (1312, 1312, False),
                                    (336, 336, False), (320, 324, False)])
def test_int8_dense_wrapper_checks(c, f, ok):
    """The checks a CUDA tensor meets before K6's launch, run on CPU tensors:
    C a multiple of 32 up to 1280 (the block's quantized rows), F of 8."""
    dense = importlib.import_module("sd_tpu_torch.ops.cuda.int8_dense")
    x = torch.zeros((256, c), dtype=torch.bfloat16)
    wq, sw = torch.zeros((f, c), dtype=torch.int8), torch.ones(f)
    if ok:
        dense._check_inputs(x, wq, sw, None)
    else:
        with pytest.raises(ValueError):
            dense._check_inputs(x, wq, sw, None)


# ------------------------------------------------------------ grammar, gates


def test_bucket_grammar(monkeypatch):
    p = quant.parse_int8
    for off in ("0", "off", "", "OFF"):
        assert p(off) == quant.INT8_OFF and not p(off)
    assert p("all").buckets == p("1").buckets == frozenset(("conv", "ff", "attn"))
    assert "attn_pv" not in p("all").buckets and "proj" not in p("all").buckets
    assert p("ff, attn").buckets == frozenset(("ff", "attn"))
    assert p("4096") == quant.Int8Mode(frozenset(("conv",)), 4096)
    with pytest.raises(ValueError):
        p("garbage")
    with pytest.raises(ValueError):
        p("conv,fff")
    monkeypatch.setenv("SD_TPU_INT8", "attn_pv,proj")
    assert p(None).buckets == frozenset(("attn_pv", "proj"))
    monkeypatch.delenv("SD_TPU_INT8")
    assert p(None) == quant.INT8_OFF


def test_gates_and_label(monkeypatch):
    mode = quant.parse_int8("ff,attn")
    cpu_bf16 = torch.zeros(1, dtype=torch.bfloat16)
    # on the CPU the gate keeps int8 off whatever the mode, and the label says so
    assert not quant.int8_bucket_enabled(mode, "ff", cpu_bf16)
    assert quant.int8_mode_label(mode, "cpu") == "bf16"
    monkeypatch.setattr(quant, "int8_device_ok", lambda x: x.dtype == torch.bfloat16)
    assert quant.int8_bucket_enabled(mode, "ff", cpu_bf16)
    assert not quant.int8_bucket_enabled(mode, "conv", cpu_bf16)
    assert not quant.int8_bucket_enabled(mode, "ff", cpu_bf16.float())  # bf16 only
    assert quant.int8_mode_label(mode, "cpu") == "bf16+int8[attn,ff]"
    thr = quant.parse_int8("4096")
    assert quant.int8_mode_label(thr, "cpu") == "bf16+int8[conv>=4096]"
    assert quant.int8_enabled(thr, torch.zeros(2, 320, 64, 64, dtype=torch.bfloat16))
    assert not quant.int8_enabled(thr, torch.zeros(2, 640, 32, 32, dtype=torch.bfloat16))
    assert quant.int8_enabled(quant.parse_int8("all"),
                              torch.zeros(2, 640, 8, 8, dtype=torch.bfloat16))
    assert quant.int8_mode_label(quant.INT8_OFF, "cpu") == "bf16"


@pytest.mark.parametrize("ask,nq,nk,want", [
    ("qk", 4096, 4096, "qk"), ("qkpv", 4096, 4096, "qkpv"), ("qk", 2048, 2048, "qk"),
    ("qk", 77, 128, "off"),     # cross-attention
    ("qk", 1024, 1024, "off"),  # measured slower in sd_tpu: bf16
    ("qk", 256, 256, "off"), ("off", 4096, 4096, "off"),
    ("qk", 2176, 2176, "off"),  # not whole 1024-key chunks
])
def test_resolve_int8_matches_sd_tpu(ask, nq, nk, want):
    q, k = torch.empty(1, nq, 1, 8), torch.empty(1, nk, 1, 8)
    assert resolve_int8(ask, q, k) == want
    if nq == nk and nk % 1024 == 0:
        assert jax_resolve_int8(ask, jnp.bfloat16, nk, nk) == want


def test_resolve_int8_from_buckets(monkeypatch):
    monkeypatch.setattr(quant, "int8_device_ok", lambda x: True)
    q40, q512 = torch.empty(1, 4096, 8, 40), torch.empty(1, 4096, 1, 512)
    pv = quant.parse_int8("attn_pv")
    assert resolve_int8(pv, q40, q40) == "qk" and resolve_int8(pv, q512, q512) == "qkpv"
    assert resolve_int8(quant.parse_int8("attn"), q512, q512) == "qk"
    assert resolve_int8(quant.parse_int8("ff,conv"), q512, q512) == "off"
    assert resolve_int8(pv, q512, q512, masked=True) == "off"
    monkeypatch.setattr(quant, "int8_device_ok", lambda x: False)
    assert resolve_int8(pv, q512, q512) == "off"


def test_small_n_attention_unchanged_by_int8(int8_on):
    mode = int8_on()
    q, k, v = (torch.from_numpy(_np(60 + i, (1, 256, 2, 64))) for i in range(3))
    with torch.no_grad():
        assert torch.equal(dot_product_attention(q, k, v, int8=mode),
                           dot_product_attention(q, k, v))


def test_ff_site_gate(monkeypatch):
    mode = quant.parse_int8("ff")
    x = lambda m, c=640: torch.empty(m, c, dtype=torch.bfloat16)
    assert not int8_ff_supported(mode, x(2048), 2560)  # the CPU
    monkeypatch.setattr(quant, "int8_device_ok", lambda t: t.dtype == torch.bfloat16)
    assert int8_ff_supported(mode, x(2048), 2560)
    assert int8_ff_supported(mode, x(1024, 1280), 5120)
    assert not int8_ff_supported(mode, x(8192, 320), 1280)   # inner below 2560: bf16
    assert not int8_ff_supported(mode, x(512, 1280), 5120)   # fewer than 1024 rows
    assert not int8_ff_supported(mode, x(1152), 2560)        # rows not a multiple of 256
    assert not int8_ff_supported(quant.parse_int8("attn"), x(2048), 2560)
    monkeypatch.setattr(port_ff, "_INT8_MIN_INNER", 0)
    assert int8_ff_supported(mode, x(8192, 320), 1280)


# ------------------------------------------------------------------ modules


def _flax(module, seed, *args):
    params = randomize_tree(module.init(jax.random.PRNGKey(0), *args)["params"],
                            np.random.default_rng(seed))
    return params, np.asarray(module.apply({"params": params}, *args))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _check_module(got, want, plain):
    """Port against sd_tpu within MODULE_TOL, and the int8 effect (the port's
    int8 against its fp32 path) at least ten times that difference."""
    diff = _rel(got, want)
    effect = _rel(got, plain)
    assert diff < MODULE_TOL, diff
    assert effect > 10 * diff, (effect, diff)


def test_conv3x3_module(int8_on):
    mode = int8_on(("conv",))
    x = _np(70, (2, 16, 16, 32))
    p, want = _flax(jconv.Conv3x3(48), 71, jnp.asarray(x))
    conv = load_numpy_state_dict(Conv3x3(32, 48), convert._conv(p))
    with torch.no_grad():
        plain = conv(_nchw(x))
        quant.set_int8_mode(conv, mode)
        got = conv(_nchw(x))
    _close(_nhwc(got), want)
    assert _rel(_nhwc(got), _nhwc(plain)) > 1e-4


def test_feedforward_module(int8_on, monkeypatch):
    mode = int8_on(("ff",))
    monkeypatch.setattr(jff, "_INT8_MIN_INNER", 0)
    monkeypatch.setattr(port_ff, "_INT8_MIN_INNER", 0)
    x = _np(72, (2, 512, 32))
    p, want = _flax(jattn.FeedForward(32, glu=True), 73, jnp.asarray(x))
    ff = FeedForward(32)
    ff.net[0].proj.weight.data = torch.from_numpy(np.asarray(p["proj_in"]["proj"]["kernel"]).T.copy())
    ff.net[0].proj.bias.data = torch.from_numpy(np.asarray(p["proj_in"]["proj"]["bias"]))
    ff.net[2].weight.data = torch.from_numpy(np.asarray(p["proj_out"]["kernel"]).T.copy())
    ff.net[2].bias.data = torch.from_numpy(np.asarray(p["proj_out"]["bias"]))
    with torch.no_grad():
        plain = ff(torch.from_numpy(x))
        quant.set_int8_mode(ff, mode)
        got = ff(torch.from_numpy(x))
    # identical inputs: the plain version's bound
    _close(got.numpy(), want)
    assert _rel(got, plain) > 1e-4


def _cross_attention(p, query_dim, context_dim, heads, dim_head):
    attn = CrossAttention(query_dim, context_dim, heads=heads, dim_head=dim_head)
    sd = {}
    for name in ("to_q", "to_k", "to_v"):
        convert._put(sd, name, convert._linear(p[name]))
    convert._put(sd, "to_out.0", convert._linear(p["to_out"]))
    return load_numpy_state_dict(attn, sd)


@pytest.mark.parametrize("cross", [False, True])
def test_cross_attention_module(int8_on, cross):
    """Self-attention at N=2048 with the proj and attn buckets (one K6 call
    for Q, K and V, K5 for the attention, K6 for to_out); cross-attention
    with Q and to_out through K6 and bf16 K and V."""
    mode = int8_on(("attn", "proj"))
    x = _np(74, (2, 2048, 64))
    ctx = _np(75, (2, 77, 48)) if cross else None
    jmod = jattn.CrossAttention(query_dim=64, context_dim=48 if cross else None, heads=4,
                                dim_head=16)
    args = (jnp.asarray(x),) + ((jnp.asarray(ctx),) if cross else ())
    p, want = _flax(jmod, 76, *args)
    attn = _cross_attention(p, 64, 48 if cross else None, 4, 16)
    targs = (torch.from_numpy(x),) + ((torch.from_numpy(ctx),) if cross else ())
    with torch.no_grad():
        plain = attn(*targs)
        quant.set_int8_mode(attn, mode)
        got = attn(*targs)
    _check_module(got, want, plain)


@pytest.mark.parametrize("c,buckets", [(64, ("attn",)), (256, ("attn_pv",))])
def test_vae_attn_block_module(int8_on, c, buckets):
    """N=2048 (32x64): "qk" at C=64, "qkpv" at C=256."""
    mode = int8_on(buckets)
    x = _np(77, (1, 32, 64, c))
    p, want = _flax(jattn.VAEAttnBlock(in_channels=c), 78, jnp.asarray(x))
    sd = {}
    convert._vae_attn(sd, p, "")
    block = load_numpy_state_dict(VAEAttnBlock(c), sd)
    with torch.no_grad():
        plain = block(_nchw(x))
        quant.set_int8_mode(block, mode)
        got = block(_nchw(x))
    # the residual carries x: compare the attention's contribution
    _check_module(_nhwc(got) - x, want - x, _nhwc(plain) - x)


# -------------------------------------------------------------------- slice

_TINY_UNET = dict(image_size=16, in_channels=4, out_channels=4, model_channels=32,
                  attention_resolutions=[1], num_res_blocks=1, channel_mult=[1, 2],
                  num_heads=4, use_spatial_transformer=True, transformer_depth=1,
                  context_dim=32)


def _damp_branches(tree, factor):
    """Scale the residual branches' last layers (each ResBlock's out_conv,
    each attention's to_out, each FF's and SpatialTransformer's proj_out,
    and the UNet's out_conv) by ``factor``."""
    return {k: (_damp_branches(v, factor) if k not in ("out_conv", "to_out", "proj_out")
                else {kk: vv * factor for kk, vv in v.items()}) if isinstance(v, dict) else v
            for k, v in tree.items()}


def test_tiny_unet_every_bucket_matches_sd_tpu(int8_on, monkeypatch):
    """A tiny UNet with attention at its first level on 32x64 latents
    (N=2048: K5), every bucket on, the FF gate's inner floor lowered to 0 in
    both packages (K4 at M=4096 and 1024), against sd_tpu's forward.

    The residual branches are drawn at 0.03 of randomize_tree's scale, as a
    trained UNet keeps them small (they start at zero). At full scale one
    activation code landing a step away at an early site, which fp32
    rounding decides, changes the next sites' inputs by a quantum and
    avalanches through the 17 quantized convs: a 1e-7 relative change of
    the input alone moves this UNet's int8 output by about 2% in either
    package, so no cross-package bound could be tight there."""
    mode = int8_on(ALL)
    monkeypatch.setattr(jff, "_INT8_MIN_INNER", 0)
    monkeypatch.setattr(port_ff, "_INT8_MIN_INNER", 0)
    x = _np(80, (2, 32, 64, 4))
    ctx = _np(81, (2, 8, 32))
    t = np.array([17, 633], np.int32)
    junet = JaxUNet(JaxUNetConfig.from_dict(_TINY_UNET))
    params = _damp_branches(randomize_tree(
        junet.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 64, 4)), jnp.zeros((1,), jnp.int32),
                   jnp.zeros((1, 8, 32)))["params"], np.random.default_rng(82)), 0.03)
    want = np.asarray(junet.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(ctx)))
    cfg = UNetConfig.from_dict(_TINY_UNET)
    unet = load_numpy_state_dict(UNetModel(cfg), convert.unet_state_dict(params, cfg))
    counts = {}
    with torch.no_grad():
        args = (_nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx))
        plain = unet(*args)
        quant.set_int8_mode(unet, mode)
        spy_launches(monkeypatch, counts)
        got = unet(*args)
    n_conv = sum(isinstance(m, Conv3x3) for m in unet.modules())
    assert counts == {"flash_attention_int8": 3, "geglu_ff_int8": 4, "int8_dense": 16,
                      "int8_conv3x3": n_conv}, counts
    _check_module(_nhwc(got), want, _nhwc(plain))


def spy_launches(monkeypatch, counts):
    """Count the port's int8 entry points by name (the CPU runs their plain
    versions, so the launch counters stay at 0 here)."""
    import sd_tpu_torch.ops.attention as attn_mod

    for mod, name in ((attn_mod, "flash_attention_int8"), (attn_mod, "geglu_ff_int8"),
                      (attn_mod, "int8_dense"), (quant, "int8_conv3x3")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)


# --------------------------------------------------------- inference-only


def test_trainer_refuses_int8():
    from sd_tpu_torch.training.diffusion_loss import create_train_state
    from sd_tpu_torch.utils.config import build_latent_diffusion, train_config

    ldm = build_latent_diffusion(train_config(tiny=True)["model"], device="cpu", int8="all")
    assert ldm.int8_mode.buckets == frozenset(("conv", "ff", "attn"))
    trainer, state = create_train_state(ldm, 1e-4, use_ema=False)
    with pytest.raises(RuntimeError, match="inference-only"):
        trainer.train_step(state, {}, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("which", ["dense", "ff", "attn", "conv"])
def test_int8_wrappers_refuse_autograd(which):
    x = torch.randn(256, 32, requires_grad=True)
    w = torch.randn(64, 32)
    calls = {
        "dense": lambda: int8_dense(x, w),
        "ff": lambda: geglu_ff_int8(x, torch.randn(256, 32), torch.zeros(256),
                                    torch.randn(32, 128), torch.zeros(32)),
        "attn": lambda: flash_attention_int8(*(torch.randn(1, 2048, 1, 8, requires_grad=True)
                                               for _ in range(3))),
        "conv": lambda: quant.int8_conv3x3(torch.randn(1, 4, 8, 8, requires_grad=True),
                                           torch.randn(4, 4, 3, 3), torch.zeros(4)),
    }
    with pytest.raises(RuntimeError, match="inference-only"):
        calls[which]()
    with torch.no_grad():
        assert torch.isfinite(calls[which]()).all()


def test_pipeline_reads_the_mode_once(monkeypatch):
    """build_txt2img_pipeline(int8=None) reads SD_TPU_INT8 when it builds;
    the mode is then held on the sites, and the weights are quantized at load
    time only where it will run."""
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline

    monkeypatch.setenv("SD_TPU_INT8", "conv,proj")
    pipe, _ = build_txt2img_pipeline(tiny=True, device="cpu", watermark=False)
    monkeypatch.setenv("SD_TPU_INT8", "0")
    convs = [m for m in pipe.ldm.modules() if isinstance(m, Conv3x3)]
    assert convs and all(m.int8.buckets == frozenset(("conv", "proj")) for m in convs)
    assert pipe.ldm.int8_mode.buckets == frozenset(("conv", "proj"))
    # fp32 on the CPU: the gate is closed, so nothing was quantized
    assert all(getattr(m, "_int8_cache", None) is None for m in convs)
    monkeypatch.setattr(quant, "int8_device_ok", lambda x: True)
    assert pipe.ldm.set_int8_mode("conv") == quant.parse_int8("conv")
    assert all(m._int8_cache is not None for m in convs)
    # the model keeps the parsed mode, conv threshold included
    pipe.ldm.set_int8_mode("4096")
    assert pipe.ldm.int8_mode == quant.Int8Mode(frozenset(("conv",)), 4096)
    assert quant.int8_mode_label(pipe.ldm.int8_mode, "cpu") == "bf16+int8[conv>=4096]"
