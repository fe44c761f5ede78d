"""The fused transformer-block experiment on the card: X1 and X2 against the
port's unfused modules (the counterpart of ``tools/exp_block_kernel.py``).

    python -m sd_tpu_torch.scripts.exp_block_kernel [N] [C]
    python -m sd_tpu_torch.scripts.exp_block_kernel tail [N] [C]

The first form runs X1 (:func:`~sd_tpu_torch.ops.cuda.fused_block`: LN +
QKV + self-attention + out-projection + residual) against
:func:`unfused_block`; ``tail`` runs X2
(:func:`~sd_tpu_torch.ops.cuda.tail_fused`: LN + cross-attention over 77
context keys padded to 128 + residual + LN + GEGLU-FF + residual) against
:func:`tail_unfused`. Both at the tool's B=16 (batch 8 doubled by guidance),
8 heads, d = C/8, inner 4C; defaults N=4096, C=320. Inputs come from a
seeded ``torch.Generator`` (see :func:`block_inputs` for their scales). The
script checks the fused output against the unfused one on what the kernel
adds to x (relative L2 of the branch within ``AGREEMENT_TOL``), times each
with the tool's chained loop (30 steps, the best of 2, CUDA events) and
prints the tool's JSON line, with ``unfused`` in place of the tool's
``xla``.

The yardsticks are what a UNet evaluation of the port runs today:
``LayerNormFp32`` and ``CrossAttention`` (self-attention through K1), and for
the tail ``to_q``, plain-op cross-attention over the given K and V,
``to_out``, ``LayerNormFp32`` and ``FeedForward`` (K2). The tool's
``tail_xla`` uses XLA's GEGLU instead of the Pallas FF; the port's FF always
takes K2, so its yardstick does too.

:func:`fused_transformer_block` applies X1 then X2 to a whole port
``BasicTransformerBlock``; the tests and ``chip_smoke.py`` hold it against
the block. The UNet does not use it.
"""

from __future__ import annotations

import json
import sys
from typing import Optional, Sequence, Tuple

import torch

from sd_tpu_torch.ops.attention import CrossAttention, FeedForward, dot_product_attention
from sd_tpu_torch.ops.cuda import block_weights, fused_block, tail_fused
from sd_tpu_torch.ops.norms import LayerNormFp32

__all__ = ["parse_args", "block_inputs", "tail_inputs", "self_attention_modules",
           "unfused_block", "tail_modules", "tail_unfused", "fused_transformer_block",
           "time_chain", "check", "run", "main"]

B = 16
HEADS = 8
KV_LEN, NK = 77, 128
ITERS, REPS = 30, 2
# fused against unfused in bf16: relative L2 of the branch, ‖fused −
# unfused‖ / ‖unfused − x0‖. The two round at other points (the single-pass
# LN variance, P against a per-tile or a per-row max, bias rounding), each
# about 2^-9 relative, which the logits' std of about 2 carries into P, so
# the two agree to about 1e-2 of the branch; a fault in the attention (a key
# dropped of every four, another head's V, the mask left out) reads tens of
# times that (tests/test_torch_block_fused.py plants such faults)
AGREEMENT_TOL = 2e-2
# The inputs' scales. The tool's (x N(0, 1), weights N(0, 0.03²)) make the
# attention's share of the output about 1/200 of x, below the resolution of
# a bf16 output, so no check of the output could see a fault in it. Here x
# is N(0, 0.25²) (LN takes out its scale), the weights are N(0, 1/fan_in) and
# wq has a gain of 2, so the logits have a std of about 2 and attention
# picks out a few keys of the N: its branch is of the order of x.
X_SCALE = 0.25
Q_GAIN = 2.0


def parse_args(argv: Sequence[str]) -> Tuple[str, int, int]:
    """The tool's grammar: ``[N] [C]`` or ``tail [N] [C]``, N=4096 and C=320
    by default. Returns ``(mode, N, C)``, mode "block" or "tail"."""
    argv = list(argv)
    mode = "block"
    if argv and argv[0] == "tail":
        mode, argv = "tail", argv[1:]
    n = int(argv[0]) if len(argv) > 0 else 4096
    c = int(argv[1]) if len(argv) > 1 else 320
    return mode, n, c


def _randn(g: torch.Generator, *shape, scale: float = 1.0) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device) * scale


def _weight(g: torch.Generator, rows: int, cols: int, gain: float = 1.0) -> torch.Tensor:
    """An ``[in, out]`` weight N(0, gain² / in) in fp32."""
    return _randn(g, rows, cols, scale=gain * rows**-0.5)


def _norm_params(g: torch.Generator, c: int):
    """LayerNorm's γ N(1, 0.1²) and β N(0, 0.1²)."""
    return 1.0 + _randn(g, c, scale=0.1), _randn(g, c, scale=0.1)


def block_inputs(n: int, c: int, device, seed: int = 0):
    """X1's inputs: x0 N(0, X_SCALE²) plus a per-row offset N(0, X_SCALE²)
    (drawn last), in bf16, so that each row's mean weighs in LayerNorm as
    much as its spread; γ, β, the fp32 ``[in, out]`` weights (wq with the
    gain Q_GAIN) and bo N(0, 0.1²) as the module's comment sets out."""
    g = torch.Generator(device=device).manual_seed(seed)
    x0 = _randn(g, B, n, c, scale=X_SCALE)
    gamma, beta = _norm_params(g, c)
    args = dict(gamma=gamma, beta=beta, wq=_weight(g, c, c, Q_GAIN),
                **{k: _weight(g, c, c) for k in ("wk", "wv", "wo")},
                bo=_randn(g, c, scale=0.1), heads=HEADS, d=c // HEADS)
    x0 = (x0 + _randn(g, B, n, 1, scale=X_SCALE)).to(torch.bfloat16)
    return x0, args


def tail_inputs(n: int, c: int, device, seed: int = 0, batch: int = B):
    """X2's inputs at :func:`block_inputs`' scales (x0 with its per-row
    offset, drawn last, so that each row's mean weighs in LN2 and, through
    x1, in LN3), inner 4C, and kc/vc N(0, 1) bf16 in all nk = 128 rows: the
    rows at or past kv_len = 77 are not zero (the tool pads with zeros), so
    only the mask keeps them out."""
    g = torch.Generator(device=device).manual_seed(seed)
    inner = 4 * c
    x0 = _randn(g, batch, n, c, scale=X_SCALE)
    (g2, b2), (g3, b3) = _norm_params(g, c), _norm_params(g, c)
    kc, vc = (_randn(g, batch, NK, c).to(torch.bfloat16) for _ in range(2))
    args = dict(g2=g2, b2=b2, wq=_weight(g, c, c, Q_GAIN), wo=_weight(g, c, c),
                bo=_randn(g, c, scale=0.1), kc=kc, vc=vc, g3=g3, b3=b3,
                w1=_weight(g, c, 2 * inner), b1=_randn(g, 2 * inner, scale=0.1),
                w2=_weight(g, inner, c), bff=_randn(g, c, scale=0.1), heads=HEADS,
                d=c // HEADS, kv_len=KV_LEN)
    x0 = (x0 + _randn(g, batch, n, 1, scale=X_SCALE)).to(torch.bfloat16)
    return x0, args


def _norm(gamma, beta) -> LayerNormFp32:
    norm = LayerNormFp32(gamma.shape[0])
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
    return norm


def _load_linear(lin, w, b=None) -> None:
    """An ``[in, out]`` weight (and bias) into an ``nn.Linear``."""
    with torch.no_grad():
        lin.weight.copy_(w.t())
        if b is not None:
            lin.bias.copy_(b)


def self_attention_modules(gamma, beta, wq, wk, wv, wo, bo, heads: int, d: int, dtype):
    """``LayerNormFp32`` and ``CrossAttention`` holding X1's weights, on
    ``wq``'s device in ``dtype``."""
    attn = CrossAttention(heads * d, heads=heads, dim_head=d)
    for lin, w in ((attn.to_q, wq), (attn.to_k, wk), (attn.to_v, wv)):
        _load_linear(lin, w)
    _load_linear(attn.to_out[0], wo, bo)
    return tuple(m.to(wq.device, dtype).eval() for m in (_norm(gamma, beta), attn))


def unfused_block(x: torch.Tensor, norm1: LayerNormFp32, attn1: CrossAttention) -> torch.Tensor:
    """X1's yardstick: ``attn1(norm1(x)) + x``, as a UNet evaluation runs it."""
    return attn1(norm1(x)) + x


def tail_modules(g2, b2, wq, wo, bo, g3, b3, w1, b1, w2, bff, heads: int, d: int, dtype):
    """``norm2``, ``attn2`` (its ``to_q`` and ``to_out``), ``norm3`` and
    ``FeedForward`` holding X2's weights, on ``wq``'s device in ``dtype``."""
    c, inner = heads * d, w2.shape[0]
    attn = CrossAttention(c, heads=heads, dim_head=d)
    _load_linear(attn.to_q, wq)
    _load_linear(attn.to_out[0], wo, bo)
    ff = FeedForward(c, mult=inner / c)
    if ff.net[2].weight.shape != (c, inner):
        raise ValueError(f"tail_modules: inner={inner} is not a multiple of C={c}")
    _load_linear(ff.net[0].proj, w1, b1)
    _load_linear(ff.net[2], w2, bff)
    mods = (_norm(g2, b2), attn, _norm(g3, b3), ff)
    return tuple(m.to(wq.device, dtype).eval() for m in mods)


def tail_unfused(x: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor, kv_len: int,
                 norm2: LayerNormFp32, attn2: CrossAttention, norm3: LayerNormFp32,
                 ff: FeedForward) -> torch.Tensor:
    """X2's yardstick: ``attn2`` over the first ``kv_len`` rows of the given
    K and V (its ``to_k``/``to_v`` already applied, as for X2), residual,
    then ``ff(norm3(x)) + x``."""
    b, n, c = x.shape
    h, d = attn2.heads, attn2.dim_head
    q = attn2.to_q(norm2(x)).view(b, n, h, d)
    k = kc[:, :kv_len].reshape(b, kv_len, h, d)
    v = vc[:, :kv_len].reshape(b, kv_len, h, d)
    att = dot_product_attention(q, k, v, scale=d**-0.5).reshape(b, n, c)
    x = attn2.to_out(att) + x
    return ff(norm3(x)) + x


def fused_transformer_block(block, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
    """A port ``BasicTransformerBlock`` on ``x [B, N, C]`` through X1 then X2,
    with :func:`~sd_tpu_torch.ops.cuda.block_weights`."""
    x1_args, x2_args = block_weights(block, context)
    return tail_fused(fused_block(x, **x1_args), **x2_args)


def time_chain(step, x0: torch.Tensor, iters: int = ITERS, reps: int = REPS) -> float:
    """The tool's chained loop: one warm-up step, then the best of ``reps``
    runs of ``iters`` steps each feeding the next, in ms per step by CUDA
    events."""
    if x0.device.type != "cuda":
        raise RuntimeError("time_chain: times on the card (CUDA events); x0 is on "
                           f"{x0.device}")
    step(x0)
    torch.cuda.synchronize(x0.device)
    best = float("inf")
    for _ in range(reps):
        x = x0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            x = step(x)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def relative_l2(got: torch.Tensor, want: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> float:
    """‖got − want‖ / ‖want‖, or with ``residual`` the relative L2 of the
    branch: ‖got − want‖ / ‖want − residual‖."""
    want = want.float()
    scale = want if residual is None else want - residual.float()
    return ((got.float() - want).norm() / scale.norm()).item()


_KEYS = {"block": ("fused", "unfused"), "tail": ("tail_fused", "tail_unfused")}


@torch.no_grad()
def check(mode: str, n: int, c: int, device):
    """Build the inputs and both steps of ``mode`` ("block": X1, "tail": X2)
    on ``device`` and check fused against unfused on the branch, what each
    adds to x0. Returns ``(x0, step_fused, step_unfused, result)``, the
    result holding the max |diff| and the branch's relative L2."""
    if mode == "block":
        x0, args = block_inputs(n, c, device)
        mods = self_attention_modules(**args, dtype=x0.dtype)
        step_fused = lambda x: fused_block(x, **args)
        step_unfused = lambda x: unfused_block(x, *mods)
    elif mode == "tail":
        x0, args = tail_inputs(n, c, device)
        kv = {k: args[k] for k in ("kc", "vc", "kv_len")}
        weights = {k: v for k, v in args.items() if k not in kv}
        mods = tail_modules(**weights, dtype=x0.dtype)
        step_fused = lambda x: tail_fused(x, **args)
        step_unfused = lambda x: tail_unfused(x, kv["kc"], kv["vc"], kv["kv_len"], *mods)
    else:
        raise ValueError(f"mode {mode!r}: expected block or tail")
    y_fused, y_unfused = step_fused(x0), step_unfused(x0)
    maxdiff = (y_fused.float() - y_unfused.float()).abs().max().item()
    rel = relative_l2(y_fused, y_unfused, residual=x0)
    if not (torch.isfinite(y_fused).all() and rel <= AGREEMENT_TOL):
        raise AssertionError(f"{mode} at N={n}, C={c}: fused against unfused, the branch's "
                             f"relative L2 "
                             f"{rel} (bound {AGREEMENT_TOL}), max |diff| {maxdiff}")
    return x0, step_fused, step_unfused, {"maxdiff": maxdiff, "relative_l2": rel}


@torch.no_grad()
def run(mode: str, n: int, c: int) -> dict:
    """:func:`check` on the card, then both steps timed by :func:`time_chain`;
    returns the tool's JSON fields and the check's."""
    x0, step_fused, step_unfused, result = check(mode, n, c, "cuda")
    fused_key, unfused_key = _KEYS[mode]
    result[fused_key] = time_chain(step_fused, x0)
    result[unfused_key] = time_chain(step_unfused, x0)
    return {**result, "n": n, "c": c}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    mode, n, c = parse_args(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise SystemExit("exp_block_kernel: times X1 and X2 on the card; no CUDA device")
    result = run(mode, n, c)
    label = "maxdiff fused vs unfused" if mode == "block" else "tail maxdiff"
    print(f"{label}: {result['maxdiff']:.4f} (the branch's relative L2 "
          f"{result['relative_l2']:.3e}, bound "
          f"{AGREEMENT_TOL})", flush=True)
    print(json.dumps({**{k: round(result[k], 3) for k in _KEYS[mode]}, "n": n, "c": c}),
          flush=True)
    return result


if __name__ == "__main__":
    main()
