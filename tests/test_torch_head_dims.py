"""The port at head dims no config of the repository reaches but sd_tpu's
kernels take, and the last two host-side functions it copies from sd_tpu, on
the CPU against sd_tpu:

- K1's plain version against ``flash_attention(..., interpret=True)`` at a
  head dim above 1024 and at one that is not a multiple of 8, within 2e-5
  absolute (fp32 softmax summed in another order, as
  test_torch_kernels.py); the zero padding the CUDA wrappers apply to such a
  head dim leaves K1's and K3's plain versions unchanged, within 1e-6 of
  the scale (the zero columns add exact zeros; the sums only regroup);
- K3's plain version against ``_bwd_bhnd_pallas(..., interpret=True)`` at a
  head dim above 512, within 1e-5 of each gradient's scale (fp32 products
  of the same operands, summed in another order);
- K5's plain version against sd_tpu's int8 kernel in interpret mode at a
  head dim above 512, at test_torch_int8.py's bounds ("qk" 1e-5 of the
  scale; "qkpv" 2e-3 of it, all but 1% of the elements within 1e-5: the two
  libraries' exp2 may put a code of P one step apart);
- ``resolve_int8`` against the int8 kernel sd_tpu's self-attention runs,
  read off ``flash_supported`` (its platform answered as a TPU) and the
  kernel ``_fwd_bhnd`` hands ``pallas_call``, over a sweep of N and d;
- ``BERTWordPieceTokenizer`` and ``embed_watermark``/``decode_watermark``
  equal to sd_tpu's on the same inputs (tests/test_extras.py's vocabularies;
  tests/test_aux_pipelines.py's images).
"""

import functools
import importlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.data.tokenizer import BERTWordPieceTokenizer as JaxWordPiece
from sd_tpu.ops.pallas import flash_attention as jax_flash
from sd_tpu.utils import watermark as jax_watermark
from sd_tpu_torch.data.tokenizer import BERTWordPieceTokenizer
from sd_tpu_torch.ops.cuda import (flash_attention_bwd_plain, flash_attention_int8,
                                   flash_attention_plain, resolve_int8)
from sd_tpu_torch.utils import watermark
from torch_parity import torch_threads

# the module, which the package's flash_attention function shadows
port_flash = importlib.import_module("sd_tpu_torch.ops.cuda.flash_attention")
torch.backends.cuda.matmul.allow_tf32 = False

FLASH_TOL = 2e-5
GRAD_TOL = 1e-5
PAD_TOL = 1e-6
INT8_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _np(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close_to_scale(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def _bhnd(x):
    """[B, N, H, D] numpy -> sd_tpu's [B, H, N, D] kernel layout."""
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("shape", [(1, 128, 1, 1280), (1, 128, 2, 44)])
def test_flash_plain_matches_pallas_at_wide_and_odd_head_dims(shape):
    q, k, v = (_np(i, shape) for i in range(3))
    want = jax_flash.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FLASH_TOL, rtol=0)


def test_padding_an_odd_head_dim_changes_nothing():
    """What the CUDA wrappers run at d = 44: Q, K, V (and O, dO) zero-padded
    to 48, the scale of 44, the padding columns of O and the gradients
    dropped."""
    shape = (1, 256, 2, 44)
    q, k, v, do = (torch.from_numpy(_np(10 + i, shape)) for i in range(4))
    scale = 44 ** -0.5
    dp = port_flash.padded_head_dim(44)
    assert dp == 48 and port_flash.padded_head_dim(48) == 48
    padded = port_flash._pad_head(dp, q, k, v, do)
    assert all(t.shape[-1] == dp and t.is_contiguous() for t in padded)
    o = flash_attention_plain(q, k, v, scale)
    o_pad = flash_attention_plain(*padded[:3], scale)
    assert torch.equal(o_pad[..., 44:], torch.zeros_like(o_pad[..., 44:]))
    _close_to_scale(o_pad[..., :44].numpy(), o.numpy(), PAD_TOL)
    want = flash_attention_bwd_plain(q, k, v, o, do, scale)
    got = flash_attention_bwd_plain(*padded[:3], o_pad, padded[3], scale)
    for g, w in zip(got, want):
        _close_to_scale(g[..., :44].numpy(), w.numpy(), PAD_TOL)


def test_flash_bwd_plain_matches_pallas_above_512():
    shape = (1, 512, 1, 768)
    q, k, v, do = (_np(20 + i, shape) for i in range(4))
    scale = shape[-1] ** -0.5
    o = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), scale).numpy()
    want = jax_flash._bwd_bhnd_pallas(*(_bhnd(a) for a in (q, k, v, o, do)), scale, shape[1],
                                      interpret=True)
    got = flash_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, o, do)), scale)
    for g, w in zip(got, want):
        _close_to_scale(g.numpy(), np.asarray(w).transpose(0, 2, 1, 3), GRAD_TOL)


@pytest.mark.parametrize("mode", ["qk", "qkpv"])
def test_flash_int8_plain_matches_pallas_above_512(mode):
    shape = (1, 2048, 1, 768)
    q, k, v = (_np(30 + i, shape) for i in range(3))
    want = np.asarray(jax_flash.flash_attention(*map(jnp.asarray, (q, k, v)), interpret=True,
                                                int8=mode))
    got = flash_attention_int8(*map(torch.from_numpy, (q, k, v)), mode=mode).numpy()
    err, scale = np.abs(got - want), np.abs(want).max()
    if mode == "qk":
        assert err.max() <= INT8_TOL * scale
    else:
        assert err.max() < 2e-3 * scale and np.mean(err > INT8_TOL * scale) < 1e-2
    plain = flash_attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    assert np.abs(got - plain).max() > 1e-4  # int8 engaged in both


def _sd_tpu_int8_kernel(monkeypatch, n: int, d: int, mode: str) -> str:
    """The int8 mode of the kernel sd_tpu's unmasked self-attention at
    [1, n, 1, d] runs on a TPU: "off" where ``flash_supported`` leaves it to
    XLA, else what ``_fwd_bhnd`` hands ``pallas_call`` (patched to record
    the kernel), traced on shapes alone (one device's program: the SPMD
    wrapper, which the test's 8 CPU devices would take, off)."""
    q = jax.ShapeDtypeStruct((1, n, 1, d), jnp.bfloat16)
    monkeypatch.setattr(jax_flash.jax, "devices", lambda *a: [types.SimpleNamespace(
        platform="tpu")])
    if not jax_flash.flash_supported(q, q, q):
        return "off"
    kernels = []

    def pallas_call(kernel, out_shape, **kwargs):
        kernels.append(kernel)
        return lambda *args: jnp.zeros(out_shape.shape, out_shape.dtype)

    monkeypatch.setattr(jax_flash.pl, "pallas_call", pallas_call)
    monkeypatch.setenv("SD_TPU_FLASH_SPMD", "0")
    jax.eval_shape(lambda t: jax_flash.flash_attention(t, t, t, int8=mode), q)
    (kernel,) = kernels
    assert isinstance(kernel, functools.partial)
    if kernel.func is not jax_flash._kernel_chunked_int8:
        return "off"
    return "qkpv" if kernel.keywords["pv_int8"] else "qk"


def test_resolve_int8_is_sd_tpus_over_n_and_d(monkeypatch):
    """Every N and d of the sweep, both modes: the port's mode equals the
    kernel sd_tpu runs, with no head-dim condition (d = 44, 768 and 1280
    engage as d = 40 does) and none past sd_tpu's rows (N > 4096 is XLA's
    there, bf16)."""
    seen = set()
    for n in (256, 1024, 2048, 2176, 3072, 4096, 5120, 8192):
        for d in (40, 44, 512, 768, 1280):
            for mode in ("qk", "qkpv"):
                want = _sd_tpu_int8_kernel(monkeypatch, n, d, mode)
                q = torch.empty(1, n, 1, d)
                assert resolve_int8(mode, q, q) == want, (n, d, mode)
                seen.add((n, want))
    assert {(2048, "qkpv"), (3072, "qk"), (4096, "qkpv"), (2176, "off"),
            (8192, "off")} <= seen


def _wordpiece_cases():
    """tests/test_extras.py's two vocabularies, and texts that reach every
    branch: continuation pieces, an unknown word, case, punctuation, other
    scripts and numbers, HTML escapes, truncation."""
    v1 = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3,
          "hello": 4, "wor": 5, "##ld": 6, "!": 7}
    v2 = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "a": 4}
    texts = ["hello world!", "xyz", "A a A", "a " * 50, "Hello, WORLD!! héllo wörld",
             "Ⅻ x² &amp; 'hello'\tworld\n", ""]
    return [(v, t) for v in (v1, v2) for t in texts]


@pytest.mark.parametrize("vocab,text", _wordpiece_cases())
def test_wordpiece_matches_sd_tpu(vocab, text):
    port, ref = BERTWordPieceTokenizer(vocab), JaxWordPiece(vocab)
    assert port.encode(text) == ref.encode(text)
    for length in (6, 77):
        np.testing.assert_array_equal(port([text, "hello"], length), ref([text, "hello"], length))


def test_wordpiece_reads_a_vocab_file(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\nhello\nwor\n##ld\n!\n", encoding="utf-8")
    port, ref = BERTWordPieceTokenizer(str(path)), JaxWordPiece(str(path))
    assert port.vocab == ref.vocab
    np.testing.assert_array_equal(port(["Hello world!"], 8), ref(["Hello world!"], 8))


@pytest.mark.parametrize("payload", [watermark.WATERMARK_PAYLOAD, b"hi"])
def test_watermark_matches_sd_tpu(payload):
    rng = np.random.default_rng(0)
    images = [(rng.random((256, 256, 3)) * 255).astype(np.uint8),
              np.full((128, 128, 3), 128, np.uint8)]
    for img in images:
        marked = watermark.embed_watermark(img, payload)
        np.testing.assert_array_equal(marked, jax_watermark.embed_watermark(img, payload))
        for x in (marked, img):
            assert (watermark.decode_watermark(x, len(payload))
                    == jax_watermark.decode_watermark(x, len(payload)))
        assert watermark.decode_watermark(marked, len(payload)) == payload
