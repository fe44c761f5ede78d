"""The port's two conv modes on the CPU, against sd_tpu's: K7 (the fused
GroupNorm-apply + SiLU + 3x3 conv, SD_TPU_FUSED_CONV) and K8 / X3 (Winograd
F(2x2,3x3), SD_TPU_CONV_IMPL=winograd).

The same numpy inputs (from a seed) go through both packages in fp32.
sd_tpu's kernels run in Pallas interpret mode, or through its plain
composite where its own dispatch takes that on the CPU (the whole UNet with
SD_TPU_FUSED_CONV=1); the port's wrappers compute their plain versions on
CPU tensors. sd_tpu is NHWC / HWIO, the port NCHW / OIHW: the tests
transpose at the boundary. Nothing in sd_tpu changes.

Tolerances (fp32 on both sides; only the order of the fp32 sums differs):
- K7, K8, X3 and their gradients: max abs difference within 1e-5 of the
  output's scale (max |sd_tpu|, at least 1), the moments within 1e-5 of
  theirs;
- fold_gn_affine: rtol 1e-6, atol 1e-6 (the same elementwise fp32 ops);
- Conv3x3's cached U (bf16) against sd_tpu's fp32 weight_transform: rtol
  2^-8, one bf16 rounding;
- the fused ResBlock and VAEResnetBlock: 2e-5 of the output's scale (two
  convs and the GroupNorm statistics between them);
- the small UNet: 1e-4 of the output's scale, as tests/test_torch_models.py
  holds the UNet;
- the gates: equal on every shape.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.models.unet import UNetConfig as JaxUNetConfig
from sd_tpu.models.unet import UNetModel as JaxUNet
from sd_tpu.ops import conv as jconv
from sd_tpu.ops import resblock as jres
from sd_tpu.ops.pallas import fused_conv as jfused
from sd_tpu.ops.pallas import winograd_conv as jwino
from sd_tpu_torch.models.unet import UNetConfig, UNetModel
from sd_tpu_torch.ops import quant
from sd_tpu_torch.ops.conv import Conv3x3
from sd_tpu_torch.ops.cuda import (fused_conv3x3, fused_conv3x3_plain, winograd_conv3x3,
                                   winograd_conv3x3_plain, winograd_conv3x3_split)
from sd_tpu_torch.ops.cuda.fused_conv import (fold_gn_affine, fused_conv_enabled,
                                              fused_conv_supported, parse_fused_conv)
from sd_tpu_torch.ops.cuda.winograd_conv import (_parity_buffer, _parity_planes,
                                                 parse_conv_impl, weight_transform,
                                                 winograd_supported)
from sd_tpu_torch.ops.norms import group_stats
from sd_tpu_torch.ops.resblock import (ResBlock, VAEResnetBlock, _fused_pair_supported,
                                       set_conv_modes)
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.testing import load_numpy_state_dict, randomize_tree

# the modules: the package exports functions of the same names
port_fused = importlib.import_module("sd_tpu_torch.ops.cuda.fused_conv")
port_res = importlib.import_module("sd_tpu_torch.ops.resblock")
port_conv = importlib.import_module("sd_tpu_torch.ops.conv")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KERNEL_TOL = 1e-5
BLOCK_TOL = 2e-5
UNET_TOL = 1e-4


def _np(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1)))


def _close(got, want, tol=KERNEL_TOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs error {err} above {tol * scale}"


# ------------------------------------------------------------------ K7


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("moments", [False, True])
def test_fused_conv_matches_pallas(prologue, bias, skip, moments):
    """x [2,32,16,256], N=256: four row tiles, and sd_tpu's Cout tile forced
    to 128 (two Cout tiles); the border rows and columns checked on their
    own, where the SAME zeros must be zeros after the prologue."""
    b, h, w, c, n = 2, 32, 16, 256, 256
    x = _np(0, (b, h, w, c))
    wk = _np(1, (3, 3, c, n), (9 * c) ** -0.5)
    kw = {}
    if prologue:
        kw["a"], kw["d"] = 1.0 + _np(2, (b, c), 0.2), _np(3, (b, c), 0.5)
    if bias:
        kw["bias"] = _np(4, (n,), 0.1)
    if skip:
        kw["skip"] = _np(5, (b, h, w, n))
    want = jfused.fused_conv3x3(jnp.asarray(x), jnp.asarray(wk), emit_moments=moments, tk=128,
                                interpret=True, **{k: jnp.asarray(v) for k, v in kw.items()})
    port_kw = {k: (_nchw(v) if k == "skip" else torch.from_numpy(v)) for k, v in kw.items()}
    got = fused_conv3x3(_nchw(x), _oihw(wk), emit_moments=moments, **port_kw)
    if not moments:
        want, got = (want,), (got,)
    y_want, y_got = np.asarray(want[0]), _nhwc(got[0])
    _close(y_got, y_want, what="y")
    for name, sl in (("top row", np.s_[:, 0]), ("bottom row", np.s_[:, -1]),
                     ("left column", np.s_[:, :, 0]), ("right column", np.s_[:, :, -1])):
        _close(y_got[sl], y_want[sl], what=name)
    for name, g, wv in zip(("sum", "sumsq"), got[1:], want[1:]):
        _close(g.numpy(), np.asarray(wv), what=name)


def test_fused_conv_border_is_zero_after_the_prologue():
    """With w = 1 at the centre-left tap only, y[..., j] = h[..., j - 1]: the
    first column reads the SAME zero, which silu(d) would not be."""
    x = torch.zeros(1, 32, 8, 16)
    w = torch.zeros(32, 32, 3, 3)
    w[torch.arange(32), torch.arange(32), 1, 0] = 1.0
    a, d = torch.ones(1, 32), torch.full((1, 32), 2.0)
    y = fused_conv3x3(x, w, a=a, d=d)
    assert torch.all(y[..., 0] == 0)
    silu2 = 2.0 / (1.0 + np.exp(-2.0))
    np.testing.assert_allclose(y[..., 1:].numpy(), silu2, rtol=1e-6)


def test_fold_gn_affine_matches_sd_tpu():
    b, g, c = 2, 32, 256
    mean, meansq = _np(10, (b, g)), np.abs(_np(11, (b, g))) + 1.0
    meansq[0, :4] = np.square(mean[0, :4])  # variance at 0: the clamp's case
    meansq[0, 4] = np.square(mean[0, 4]) - 1e-6
    scale, bias = 1.0 + _np(12, (c,), 0.1), _np(13, (c,), 0.1)
    extras = dict(extra_scale=1.0 + _np(14, (b, c), 0.1), channel_offset=_np(15, (b, c)),
                  extra_shift=_np(16, (b, c), 0.1))
    for kw in ({}, extras):
        want = jfused.fold_gn_affine(*map(jnp.asarray, (mean, meansq, scale, bias)), 1e-5,
                                     **{k: jnp.asarray(v) for k, v in kw.items()})
        got = fold_gn_affine(*map(torch.from_numpy, (mean, meansq, scale, bias)), 1e-5,
                             **{k: torch.from_numpy(v) for k, v in kw.items()})
        for gv, wv in zip(got, want):
            assert gv.dtype == torch.float32 and torch.isfinite(gv).all()
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6, atol=1e-6)


def test_group_stats_matches_sd_tpu():
    from sd_tpu.ops.norms import group_stats as jax_group_stats

    x = 2.0 + _np(17, (2, 8, 8, 128))
    for got, want in zip(group_stats(_nchw(x), 32), jax_group_stats(jnp.asarray(x), 32)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_fused_conv_grads_match_jax():
    """Gradients of every input, through y and both moments, against
    jax.grad through sd_tpu's custom_vjp (recompute through _reference)."""
    b, h, w, c, n = 1, 16, 16, 128, 128
    names = ("x", "w", "a", "d", "bias", "skip")
    vals = [_np(20, (b, h, w, c)), _np(21, (3, 3, c, n), (9 * c) ** -0.5),
            1.0 + _np(22, (b, c), 0.1), _np(23, (b, c), 0.3), _np(24, (n,), 0.1),
            _np(25, (b, h, w, n))]
    gy, g1, g2 = _np(26, (b, h, w, n)), _np(27, (b, n)), _np(28, (b, n), 1e-3)

    def jloss(x, wk, a, d, bias, skip):
        y, s1, s2 = jfused.fused_conv3x3(x, wk, a=a, d=d, bias=bias, skip=skip,
                                         emit_moments=True, interpret=True)
        return jnp.sum(y * gy) + jnp.sum(s1 * g1) + jnp.sum(s2 * g2)

    want = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, vals))
    to_port = {"x": _nchw, "w": _oihw, "skip": _nchw}
    leaves = [to_port.get(k, torch.from_numpy)(v).requires_grad_() for k, v in zip(names, vals)]
    x, wk, a, d, bias, skip = leaves
    y, s1, s2 = fused_conv3x3(x, wk, a=a, d=d, bias=bias, skip=skip, emit_moments=True)
    loss = ((y * _nchw(gy)).sum() + (s1 * torch.from_numpy(g1)).sum()
            + (s2 * torch.from_numpy(g2)).sum())
    got = torch.autograd.grad(loss, leaves)
    from_port = {"x": _nhwc, "w": lambda t: t.detach().numpy().transpose(2, 3, 1, 0),
                 "skip": _nhwc}
    for name, gv, wv in zip(names, got, want):
        _close(from_port.get(name, lambda t: t.detach().numpy())(gv), wv, what=name)


def test_fused_conv_under_autocast():
    """Under autocast (the trainer's bf16 autocast), the autograd function
    runs K7's function on the autocast dtype and the fp32 leaves get their
    gradients."""
    x = torch.from_numpy(_np(32, (1, 128, 8, 16))).requires_grad_()
    w = torch.from_numpy(_np(33, (128, 128, 3, 3), 0.03)).requires_grad_()
    a, d = torch.ones(1, 128, requires_grad=True), torch.zeros(1, 128)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        y = fused_conv3x3(x, w, a=a, d=d)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    for t in (x, w, a):
        assert t.grad is not None and t.grad.dtype == torch.float32
        assert torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0


def test_fused_conv_plain_is_the_reference_with_bf16_rounding():
    """The plain version rounds h and y to bf16 where the kernel does, and
    squares the rounded y in fp32 for the moments."""
    x = torch.from_numpy(_np(30, (1, 128, 8, 16))).bfloat16()
    w = torch.from_numpy(_np(31, (128, 128, 3, 3), 0.03)).bfloat16()
    a, d = torch.ones(1, 128), torch.zeros(1, 128)
    y, s1, s2 = fused_conv3x3_plain(x, w, a, d, emit_moments=True)
    assert y.dtype == torch.bfloat16
    h = torch.nn.functional.silu(x.float()).bfloat16().float()
    want = torch.nn.functional.conv2d(h, w.float(), padding=1).bfloat16()
    assert torch.equal(y, want)
    torch.testing.assert_close(s2, want.float().square().sum((2, 3)), rtol=1e-6, atol=0)


# --------------------------------------------------------------- gates


def _sd_v1_blocks():
    """(B, H=W, Cin, Cout) of every resnet block of SD v1 serving at 512²
    with guidance: the UNet's at B=2, the decoder's at B=1."""
    unet = ([(64, 320, 320)] * 2 + [(32, 320, 640), (32, 640, 640), (16, 640, 1280),
                                      (16, 1280, 1280)] + [(8, 1280, 1280)] * 4
            + [(8, 2560, 1280)] * 3 + [(16, 2560, 1280)] * 2
            + [(16, 1920, 1280), (32, 1920, 640), (32, 1280, 640), (32, 960, 640),
               (64, 960, 320), (64, 640, 320), (64, 640, 320)])
    dec = ([(64, 512, 512)] * 5 + [(128, 512, 512)] * 3 + [(256, 512, 256)]
           + [(256, 256, 256)] * 2 + [(512, 256, 128)] + [(512, 128, 128)] * 2)
    return [(2,) + s for s in unet] + [(1,) + s for s in dec]


def _sd_v1_conv_shapes():
    """NCHW x and OIHW w of every 3x3 conv site: both convs of every block,
    the upsample convs, the decoder's conv_in/conv_out, the test_fused_conv
    and test_winograd_conv gate shapes, and X3's four levels at B=16."""
    shapes = []
    for b, hw, cin, cout in _sd_v1_blocks():
        shapes += [((b, cin, hw, hw), (cout, cin, 3, 3)), ((b, cout, hw, hw), (cout, cout, 3, 3))]
    shapes += [((2, c, hw, hw), (c, c, 3, 3)) for hw, c in ((16, 1280), (32, 1280), (64, 640))]
    shapes += [((1, c, hw, hw), (c, c, 3, 3)) for hw, c in ((128, 512), (256, 512), (512, 256))]
    shapes += [((1, 4, 64, 64), (512, 4, 3, 3)), ((1, 128, 512, 512), (3, 128, 3, 3))]
    for xs, ws in (((2, 32, 32, 640), (3, 3, 640, 640)), ((2, 16, 16, 2560), (3, 3, 2560, 1280)),
                   ((2, 64, 64, 320), (3, 3, 320, 320)), ((2, 8, 8, 1280), (3, 3, 1280, 1280)),
                   ((2, 64, 64, 4), (3, 3, 4, 320)), ((2, 64, 64, 320), (3, 3, 320, 4)),
                   ((16, 63, 64, 320), (3, 3, 320, 320)), ((16, 32, 32, 1920), (3, 3, 1920, 640)),
                   ((16, 36, 64, 320), (3, 3, 320, 320))):
        shapes.append(((xs[0], xs[3], xs[1], xs[2]), (ws[3], ws[2], 3, 3)))
    shapes += [((16, c, hw, hw), (c, c, 3, 3)) for hw, c in ((64, 320), (32, 640), (16, 1280),
                                                             (8, 1280))]
    return shapes


def _hwio(w_shape):
    return (3, 3, w_shape[1], w_shape[0])


def _nhwc_shape(x_shape):
    return (x_shape[0], x_shape[2], x_shape[3], x_shape[1])


def test_fused_gate_matches_sd_tpu_at_every_site():
    for xs, ws in _sd_v1_conv_shapes():
        for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            assert fused_conv_supported(xs, ws, dt) == jfused.fused_conv_supported(
                _nhwc_shape(xs), _hwio(ws), jdt), (xs, ws, dt)
    for b, hw, cin, cout in _sd_v1_blocks():
        assert _fused_pair_supported((b, cin, hw, hw), cout, torch.bfloat16) == \
            jres._fused_pair_supported((b, hw, hw, cin), cout, jnp.bfloat16), (hw, cin, cout)
    # the sites counted in chip_smoke.py: 8 UNet blocks, 10 decoder blocks
    taken = [s for s in _sd_v1_blocks()
             if _fused_pair_supported((s[0], s[2], s[1], s[1]), s[3], torch.bfloat16)]
    assert sum(s[0] == 2 for s in taken) == 8 and sum(s[0] == 1 for s in taken) == 10


def test_winograd_gate_matches_sd_tpu_on_shapes(monkeypatch):
    """sd_tpu's gate also asks for SD_TPU_CONV_IMPL=winograd and the TPU
    backend; with both granted, it is a function of the shapes, as the
    port's is on a CUDA bf16 tensor."""
    monkeypatch.setenv("SD_TPU_CONV_IMPL", "winograd")
    monkeypatch.setattr(jwino.jax, "devices", lambda *a: [SimpleNamespace(platform="tpu")])
    for xs, ws in _sd_v1_conv_shapes():
        want = jwino.winograd_supported(_nhwc_shape(xs), _hwio(ws), jnp.bfloat16)
        assert winograd_supported(xs, ws, torch.bfloat16, "cuda") == want, (xs, ws)
        assert not winograd_supported(xs, ws, torch.float32, "cuda")
        assert not winograd_supported(xs, ws, torch.bfloat16, "cpu")


@pytest.mark.parametrize("shape,error", [
    ((1, 128, 8, 16), None),
    ((1, 128, 8, 24), ValueError),    # W % 16
    ((1, 96 + 8, 8, 16), ValueError),  # C % 64
    ((1, 128, 12, 32), ValueError),   # H % the kernel's 8 rows
    ((1, 160, 8, 16), ValueError),    # C % 64: the kernel's 64-channel steps
])
def test_fused_wrapper_checks(shape, error):
    """The checks a CUDA tensor meets before the launch, run on CPU tensors."""
    x = torch.zeros(shape, dtype=torch.bfloat16)
    w = torch.zeros((128, shape[1], 3, 3), dtype=torch.bfloat16)
    if error is None:
        port_fused._check_inputs(x, w, None, None, None, None)
        with pytest.raises(TypeError):
            port_fused._check_inputs(x.float(), w, None, None, None, None)
        with pytest.raises(ValueError):
            port_fused._check_inputs(x, w, torch.zeros(1, 7), torch.zeros(1, 7), None, None)
    else:
        with pytest.raises(error):
            port_fused._check_inputs(x, w, None, None, None, None)


def test_fused_wrapper_takes_every_site_sd_tpu_admits():
    """Wherever sd_tpu's gate admits a bf16 site, the kernel's checks pass
    (shapes only: tensors on the meta device)."""
    admitted = 0
    for xs, ws in _sd_v1_conv_shapes():
        if not jfused.fused_conv_supported(_nhwc_shape(xs), _hwio(ws), jnp.bfloat16):
            continue
        admitted += 1
        x = torch.empty(xs, dtype=torch.bfloat16, device="meta")
        w = torch.empty(ws, dtype=torch.bfloat16, device="meta")
        b, n = xs[0], ws[0]
        ad = torch.empty((b, xs[1]), device="meta")
        wk = torch.empty((9, n, xs[1]), dtype=torch.bfloat16, device="meta")
        skip = torch.empty((b, n) + tuple(xs[2:]), dtype=torch.bfloat16, device="meta")
        port_fused._check_inputs(x, w, ad, ad, torch.empty(n, device="meta"), skip, wk)
    assert admitted >= 18


def test_fused_weight_repack_is_sd_tpu_w9():
    """The kernel's weight layout wk [9, N, C] is sd_tpu's w9 = HWIO
    reshaped to [9, C, N] with its last two axes swapped, bit for bit."""
    w_hwio = _np(20, (3, 3, 64, 48))
    w9 = np.asarray(jnp.asarray(w_hwio).reshape(9, 64, 48))
    wk = port_fused.repack_weight(_oihw(w_hwio).to(torch.bfloat16))
    assert wk.shape == (9, 48, 64) and wk.is_contiguous()
    want = torch.from_numpy(np.ascontiguousarray(w9.transpose(0, 2, 1))).to(torch.bfloat16)
    assert torch.equal(wk, want)


def test_fused_weight_cache_follows_the_weight():
    """repacked_weight keeps one repack per weight version on the module: the
    same tensor on a second call, a new one after an in-place edit or a
    replaced weight, for any nn.Conv2d."""
    conv = torch.nn.Conv2d(16, 24, 3, padding=1)
    first = port_fused.repacked_weight(conv, torch.bfloat16)
    assert port_fused.repacked_weight(conv, torch.bfloat16) is first
    assert torch.equal(first, port_fused.repack_weight(conv.weight.to(torch.bfloat16)))
    with torch.no_grad():
        conv.weight.mul_(2.0)
    second = port_fused.repacked_weight(conv, torch.bfloat16)
    assert second is not first
    assert torch.equal(second, port_fused.repack_weight(conv.weight.to(torch.bfloat16)))
    conv.weight = torch.nn.Parameter(torch.ones_like(conv.weight))
    third = port_fused.repacked_weight(conv, torch.bfloat16)
    assert torch.equal(third, port_fused.repack_weight(conv.weight.to(torch.bfloat16)))
    assert port_fused.repacked_weight(conv, torch.float32).dtype == torch.float32


def test_fused_block_reads_the_cache_only_without_autograd(monkeypatch):
    """A fused ResBlock gives K7 the module's cached repack where autograd
    does not record, and no repack (the call makes its own) where it does."""
    torch.manual_seed(0)
    block = ResBlock(128, 32, out_channels=128)
    block.conv_impl = "force"
    seen = []
    real = port_res.fused_conv3x3

    def spy(*args, **kwargs):
        seen.append(kwargs.get("wk"))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_res, "fused_conv3x3", spy)
    x, emb = torch.randn(1, 128, 8, 16), torch.randn(1, 32)
    with torch.no_grad():
        block(x, emb)
        block(x, emb)
    conv1, conv2 = block.in_layers[2], block.out_layers[3]
    assert seen[0] is seen[2] and seen[1] is seen[3]
    assert torch.equal(seen[0], port_fused.repack_weight(conv1.weight))
    assert torch.equal(seen[1], port_fused.repack_weight(conv2.weight))
    seen.clear()
    block(x, emb).sum().backward()
    assert seen == [None, None]


# ---------------------------------------------------------- the blocks


def _flax(module, seed, *args):
    params = randomize_tree(module.init(jax.random.PRNGKey(0), *args)["params"],
                            np.random.default_rng(seed))
    return params, np.asarray(module.apply({"params": params}, *args))


@pytest.mark.parametrize("cin,cout,film", [(128, 128, False), (128, 256, False),
                                           (128, 128, True), (256, 128, True)])
def test_fused_resblock_matches_sd_tpu(cin, cout, film):
    x, emb = _np(40, (2, 16, 16, cin)), _np(41, (2, 64))
    p, want = _flax(jres.ResBlock(channels=cin, emb_channels=64, out_channels=cout,
                                  use_scale_shift_norm=film, conv_impl="force", interpret=True),
                    42, jnp.asarray(x), jnp.asarray(emb))
    sd = {}
    convert._res(sd, p, "")
    block = load_numpy_state_dict(ResBlock(cin, 64, out_channels=cout,
                                           use_scale_shift_norm=film), sd)
    block.conv_impl = "force"
    assert port_res._takes_fused_path(block, block.out_layers[2], block.out_layers[3], _nchw(x))
    with torch.no_grad():
        got = block(_nchw(x), torch.from_numpy(emb))
    _close(_nhwc(got), want, BLOCK_TOL)


@pytest.mark.parametrize("cin,cout", [(128, 128), (128, 256)])
def test_fused_vae_resnet_block_matches_sd_tpu(cin, cout):
    x = _np(43, (1, 16, 16, cin))
    p, want = _flax(jres.VAEResnetBlock(in_channels=cin, out_channels=cout, conv_impl="force",
                                        interpret=True), 44, jnp.asarray(x))
    sd = {}
    convert._vae_res(sd, p, "")
    block = load_numpy_state_dict(VAEResnetBlock(cin, cout), sd)
    block.conv_impl = "force"
    assert port_res._takes_fused_path(block, block.dropout, block.conv2, _nchw(x))
    with torch.no_grad():
        got = block(_nchw(x))
    _close(_nhwc(got), want, BLOCK_TOL)


def test_fused_path_taken_only_where_sd_tpu_takes_it(monkeypatch):
    """The dispatch: off under "auto" and "off"; in training mode with
    dropout > 0 unfused; a channel count the gate refuses unfused."""
    calls = []
    real = port_res.fused_conv3x3
    monkeypatch.setattr(port_res, "fused_conv3x3", lambda *a, **k: calls.append(1) or real(*a, **k))
    emb = torch.zeros(1, 64)
    block = ResBlock(128, 64, dropout=0.1)
    x = torch.randn(1, 128, 16, 16)
    for mode, train, want in (("auto", False, 0), ("off", False, 0), ("force", True, 0),
                              ("force", False, 2)):
        calls.clear()
        block.conv_impl = mode
        block.train(train)
        with torch.no_grad():
            block(x, emb)
        assert len(calls) == want, (mode, train)
    calls.clear()
    small = ResBlock(64, 64).eval()
    small.conv_impl = "force"
    with torch.no_grad():
        small(torch.randn(1, 64, 16, 16), emb)
    assert not calls


# ------------------------------------------------------------ K8 and X3


@pytest.mark.parametrize("shape,k", [((2, 16, 32, 128), 128), ((1, 64, 32, 128), 256),
                                     ((1, 32, 32, 256), 128)])
def test_winograd_matches_pallas(shape, k):
    """K8's and X3's function against sd_tpu's winograd_conv3x3 in interpret
    mode (X3's JAX kernel is a closure inside timing_split: it is held
    against K8's, the same conv)."""
    x = _np(50, shape)
    wk = _np(51, (3, 3, shape[3], k), (9 * shape[3]) ** -0.5)
    want = np.asarray(jwino.winograd_conv3x3(jnp.asarray(x), jnp.asarray(wk), interpret=True))
    for fn in (winograd_conv3x3, winograd_conv3x3_split, winograd_conv3x3_plain):
        _close(_nhwc(fn(_nchw(x), _oihw(wk))), want, what=fn.__name__)


def test_weight_transform_matches_sd_tpu():
    wk = _np(52, (3, 3, 24, 40))
    np.testing.assert_allclose(weight_transform(_oihw(wk)).numpy(),
                               np.asarray(jwino.weight_transform(jnp.asarray(wk))), rtol=1e-6,
                               atol=1e-6)


def test_winograd_odd_size_raises():
    with pytest.raises(ValueError, match="even"):
        winograd_conv3x3(torch.zeros(1, 8, 9, 8), torch.zeros(8, 8, 3, 3))


def test_winograd_grads_match_jax():
    x = _np(53, (1, 16, 32, 128))
    wk = _np(54, (3, 3, 128, 128), (9 * 128) ** -0.5)
    g = _np(55, (1, 16, 32, 128))
    want = jax.grad(lambda a, b: jnp.sum(jwino.winograd_conv3x3(a, b, interpret=True) * g),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wk))
    for fn in (winograd_conv3x3, winograd_conv3x3_split):
        xt, wt = _nchw(x).requires_grad_(), _oihw(wk).requires_grad_()
        gx, gw = torch.autograd.grad((fn(xt, wt) * _nchw(g)).sum(), (xt, wt))
        _close(_nhwc(gx), want[0], what="dx")
        _close(gw.numpy().transpose(2, 3, 1, 0), want[1], what="dw")


def test_winograd_with_u_matches_pallas_off_the_block_multiples():
    """K8 and X3 given U, at a shape whose tile grid (9 x 17) and C (136) are
    not multiples of any plan's patch and channel step, against sd_tpu's
    winograd_conv3x3 in interpret mode."""
    x = _np(60, (1, 18, 34, 136))
    wk = _np(61, (3, 3, 136, 136), (9 * 136) ** -0.5)
    want = np.asarray(jwino.winograd_conv3x3(jnp.asarray(x), jnp.asarray(wk), interpret=True))
    u = weight_transform(_oihw(wk))
    for fn in (winograd_conv3x3, winograd_conv3x3_split):
        _close(_nhwc(fn(_nchw(x), _oihw(wk), u=u)), want, what=fn.__name__)


def test_parity_buffer_holds_the_four_planes():
    """K8's one-copy input at an odd S + 1 (17, pitch 24): plane P_ij at
    [:, :, i, j], its S + 1 columns as _parity_planes builds them, zeros in
    the pitch's padding."""
    x = torch.from_numpy(_np(62, (2, 3, 10, 32)))
    buf, s1p = _parity_buffer(x)
    assert s1p == 24 and buf.shape == (2, 3, 2, 2, 6, 24) and buf.is_contiguous()
    planes = _parity_planes(x)
    for i in range(2):
        for j in range(2):
            assert torch.equal(buf[:, :, i, j, :, :17], planes[2 * i + j])
            assert not buf[:, :, i, j, :, 17:].any()


def _winograd_conv3x3_module(seed, cin, cout, dtype=torch.float32):
    conv = Conv3x3(cin, cout).to(dtype)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(_np(seed, (cout, cin, 3, 3), (9 * cin) ** -0.5)))
    conv.impl = "winograd"
    return conv


def test_conv3x3_winograd_u_is_cached_per_weight_version():
    """Conv3x3 keeps U = weight_transform(w) rounded to the dtype, equal to
    sd_tpu's weight_transform within that rounding, computed once and again
    after an in-place edit of the weight."""
    conv = _winograd_conv3x3_module(63, 24, 40, torch.bfloat16)
    u = conv.winograd_u(torch.bfloat16)
    assert u.dtype == torch.bfloat16 and u.shape == (16, 24, 40)
    assert torch.equal(u, weight_transform(conv.weight).to(torch.bfloat16))
    w_hwio = conv.weight.detach().float().permute(2, 3, 1, 0).numpy()
    want = np.asarray(jwino.weight_transform(jnp.asarray(w_hwio)))
    np.testing.assert_allclose(u.float().numpy(), want, rtol=2**-8, atol=1e-6)
    assert conv.winograd_u(torch.bfloat16) is u
    with torch.no_grad():
        conv.weight.mul_(2)
    again = conv.winograd_u(torch.bfloat16)
    assert again is not u
    assert torch.equal(again, weight_transform(conv.weight).to(torch.bfloat16))


def test_conv3x3_winograd_u_cache_serves_without_autograd_only(monkeypatch):
    """Under no_grad Conv3x3 hands K8 its cached U; while autograd records it
    does not, and its gradients still match jax.grad of sd_tpu's kernel in
    interpret mode."""
    monkeypatch.setattr(port_conv, "winograd_supported", lambda *a: True)
    seen = []
    real = port_conv.winograd_conv3x3
    monkeypatch.setattr(port_conv, "winograd_conv3x3",
                        lambda x, w, u=None: seen.append(u) or real(x, w, u=u))
    conv = _winograd_conv3x3_module(64, 128, 128)
    x = _np(65, (1, 16, 32, 128))
    g = _np(66, (1, 16, 32, 128))
    with torch.no_grad():
        conv(_nchw(x))
    assert seen[-1] is conv.winograd_u(torch.float32)
    del conv._winograd_cache
    xt = _nchw(x).requires_grad_()
    gx, gw = torch.autograd.grad((conv(xt) * _nchw(g)).sum(), (xt, conv.weight))
    assert seen[-1] is None and not hasattr(conv, "_winograd_cache")
    w_hwio = conv.weight.detach().permute(2, 3, 1, 0).numpy()
    want = jax.grad(lambda a, b: jnp.sum(jwino.winograd_conv3x3(a, b, interpret=True) * g),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w_hwio))
    _close(_nhwc(gx), want[0], what="dx")
    _close(gw.numpy().transpose(2, 3, 1, 0), want[1], what="dw")


def test_conv3x3_winograd_matches_sd_tpu(monkeypatch):
    """Conv3x3 through K8's path (sd_tpu's impl="winograd"; the port's gate,
    which asks for a CUDA bf16 tensor, opened), bias added after the conv."""
    x = _np(56, (1, 16, 32, 128))
    p, want = _flax(jconv.Conv3x3(128, impl="winograd", interpret=True), 57, jnp.asarray(x))
    conv = load_numpy_state_dict(Conv3x3(128, 128), convert._conv(p))
    conv.impl = "winograd"
    calls = []
    monkeypatch.setattr(port_conv, "winograd_supported", lambda *a: calls.append(1) or True)
    with torch.no_grad():
        _close(_nhwc(conv(_nchw(x))), want)
    assert calls == [1]


def test_conv3x3_dispatch_order(monkeypatch):
    """Winograd where the mode and gate say so, ahead of the int8 conv; the
    int8 conv under "auto" where its bucket is on; else F.conv2d."""
    calls = []
    monkeypatch.setattr(port_conv, "winograd_supported", lambda *a: True)
    monkeypatch.setattr(quant, "int8_device_ok", lambda x: True)
    for name in ("winograd_conv3x3",):
        real = getattr(port_conv, name)
        monkeypatch.setattr(port_conv, name, lambda *a, _r=real: calls.append("wino") or _r(*a))
    real_int8 = quant.int8_conv3x3
    monkeypatch.setattr(quant, "int8_conv3x3",
                        lambda *a, **k: calls.append("int8") or real_int8(*a, **k))
    conv = Conv3x3(16, 16).eval()
    x = torch.randn(1, 16, 8, 8)
    with torch.no_grad():
        for impl, int8, want in (("winograd", "conv", "wino"), ("auto", "conv", "int8"),
                                 ("auto", "off", None), ("winograd", "off", "wino")):
            calls.clear()
            conv.impl, conv.int8 = impl, quant.parse_int8(int8)
            conv(x)
            assert calls == ([want] if want else []), (impl, int8)


# --------------------------------------------------------- the slice


_SMALL_UNET = dict(image_size=32, in_channels=4, out_channels=4, model_channels=128,
                   attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2],
                   num_heads=4, use_spatial_transformer=True, transformer_depth=1,
                   context_dim=32)


def test_small_unet_fused_matches_sd_tpu(monkeypatch):
    """A UNet with model_channels 128 and channel_mult [1, 2] on 32² latents,
    whose resnet blocks all pass K7's gate, with SD_TPU_FUSED_CONV=1 in both
    packages: sd_tpu runs its plain composite on the CPU, the port its plain
    version of K7, read once into the modules."""
    monkeypatch.setenv("SD_TPU_FUSED_CONV", "1")
    x, ctx = _np(60, (2, 32, 32, 4)), _np(61, (2, 8, 32))
    t = np.array([17, 633], np.int32)
    junet = JaxUNet(JaxUNetConfig.from_dict(_SMALL_UNET))
    params = randomize_tree(
        junet.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,), jnp.int32),
                   jnp.zeros((1, 8, 32)))["params"], np.random.default_rng(62))
    want = np.asarray(junet.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(ctx)))
    cfg = UNetConfig.from_dict(_SMALL_UNET)
    unet = load_numpy_state_dict(UNetModel(cfg), convert.unet_state_dict(params, cfg))
    assert set_conv_modes(unet) == ("force", "auto")
    monkeypatch.delenv("SD_TPU_FUSED_CONV")
    calls = []
    real = port_res.fused_conv3x3
    monkeypatch.setattr(port_res, "fused_conv3x3", lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        got = unet(_nchw(x), torch.from_numpy(t).long(), torch.from_numpy(ctx))
    blocks = sum(isinstance(m, ResBlock) for m in unet.modules())
    assert len(calls) == 2 * blocks == 16
    _close(_nhwc(got), want, UNET_TOL)


def test_conv_modes_read_once_at_build(monkeypatch):
    """build_txt2img_pipeline reads SD_TPU_FUSED_CONV and SD_TPU_CONV_IMPL
    when it builds (None), holds them on the modules, and takes keyword
    arguments before the variables; unknown values raise."""
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline

    monkeypatch.setenv("SD_TPU_FUSED_CONV", "1")
    monkeypatch.setenv("SD_TPU_CONV_IMPL", "winograd")
    pipe, _ = build_txt2img_pipeline(tiny=True, device="cpu", watermark=False)
    monkeypatch.setenv("SD_TPU_FUSED_CONV", "0")
    monkeypatch.delenv("SD_TPU_CONV_IMPL")
    ldm = pipe.ldm
    assert (ldm.fused_conv, ldm.conv_impl) == ("force", "winograd")
    blocks = [m for m in ldm.modules() if isinstance(m, (ResBlock, VAEResnetBlock))]
    convs = [m for m in ldm.modules() if isinstance(m, Conv3x3)]
    assert blocks and all(m.conv_impl == "force" for m in blocks)
    assert convs and all(m.impl == "winograd" for m in convs)
    pipe, _ = build_txt2img_pipeline(tiny=True, device="cpu", watermark=False,
                                     fused_conv="force", conv_impl="auto")
    assert (pipe.ldm.fused_conv, pipe.ldm.conv_impl) == ("force", "auto")
    pipe, _ = build_txt2img_pipeline(tiny=True, device="cpu", watermark=False)
    assert (pipe.ldm.fused_conv, pipe.ldm.conv_impl) == ("off", "auto")
    assert [parse_fused_conv(v) for v in ("auto", "0", "off", "1", "force", "")] == \
        ["auto", "off", "off", "force", "force", "auto"]
    assert not fused_conv_enabled("auto") and fused_conv_enabled("1")
    assert parse_conv_impl("winograd") == "winograd" and parse_conv_impl("xla") == "auto"
    for bad in (lambda: parse_fused_conv("2"), lambda: parse_conv_impl("fft")):
        with pytest.raises(ValueError):
            bad()
