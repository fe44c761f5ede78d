"""X1 and X2: the fused transformer-block kernels of the block experiment.

X1 (:func:`fused_block`) is one ``BasicTransformerBlock``'s ``norm1`` +
``attn1`` + residual; X2 (:func:`tail_fused`) is ``norm2`` + ``attn2`` (with
the context's K and V projected outside the kernel) + residual + ``norm3`` +
``ff`` + residual. Together they compute the whole block
(:func:`block_weights` turns a port block and its context into their
arguments). X1 replaces the TPU kernel ``_kernel`` through ``fused_block``
of ``tools/exp_block_kernel.py``, X2 ``_tail_kernel`` through
``tail_fused``; their CUDA sources are ``sd_tpu_torch/csrc/fused_block.cu``
and ``sd_tpu_torch/csrc/tail_fused.cu`` (the launches they share are in
``fused_block.cuh``), whose headers say what bounds them on the H100 and
why X1 is two launches there and X2 four or more: its attention half on
X1's two launches, its feed-forward on K2's GEMM pair with x1 added in the
second's epilogue (:func:`tail_attention_plain` and
``geglu_ff_plain(..., residual=x1)`` are the two halves' functions).

The arguments are the tool's: ``x [B, N, C]``, weights ``[in, out]`` in any
float type (cast to ``x``'s, as the tool casts them), LayerNorm and bias
vectors kept in fp32, ``w1 [C, 2·inner]`` with the value half first,
``kc``/``vc [B, nk, C]`` of which the first ``kv_len`` rows are keys. ``wq``
is scaled by ``d**-0.5 * log2(e)`` in fp32 and rounded to the working type
once, as the tool does. ``chunk`` and ``block_q`` are the TPU kernels' tile
sizes and do not change the function here: the kernels attend over every key
and write every row (the TPU kernels drop the last N mod chunk keys and the
last N mod block_q rows; see ROADMAP).

The wrappers launch the kernels for a CUDA tensor (bf16 only; a shape the
kernels do not take raises) and use the plain versions for a CPU tensor
only. The kernels read the weights in torch ``Linear`` layout (out x in):
:func:`x1_weights` makes X1's ``[Wq' | Wk | Wv]ᵀ`` and ``Woᵀ``,
:func:`x2_weights` X2's ``Wq'ᵀ``, ``Woᵀ``, ``W1ᵀ`` and ``W2ᵀ``, once per
weight version, and keeps them (a weight edited in place or replaced is
prepared again); :func:`x1_plan` and :func:`x2_plan` read the launch plans.
Both functions are forward-only, as the TPU kernels are: an input
that requires grad raises where autograd would record. ``fused_block.launches``
and ``tail_fused.launches`` count calls that launched (one per call, whatever
the internal launches).
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from collections import OrderedDict

import torch
import torch.nn.functional as F

from sd_tpu_torch.ops.cuda._build import check, kernels, stream_of

__all__ = ["fused_block", "fused_block_plain", "tail_fused", "tail_fused_plain",
           "tail_attention_plain", "block_weights", "layer_norm_single_pass", "x1_weights",
           "x2_weights", "x1_plan", "x2_plan"]

_LOG2E = math.log2(math.e)
_LN_EPS = 1e-5
# block_weights pads the context's K and V rows to a multiple of this (the
# tool pads 77 to 128; the kernels read only the first kv_len rows)
_KV_PAD = 16
# X1's and X2's prepared weights kept: a few weight sets of each (the
# experiment's four sites)
_CACHE_SIZE = 16
_weight_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
# the widest head and row X1's kernels take (csrc/fused_block.cuh), and so
# X2's attention launches
_X1_MAX_D = 160
_X1_MAX_C = 1280


def layer_norm_single_pass(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor) -> torch.Tensor:
    """The tool's ``_ln``: fp32 mean and E[x²] in one pass, ``var = E[x²] −
    mean²`` clamped at 0 (as ``GroupNorm32`` does; a no-op wherever the tool
    is finite), ``(x − mean) · rsqrt(var + 1e-5) · γ + β`` rounded to ``x``'s
    dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * torch.rsqrt(var + _LN_EPS)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def _scaled_q(wq: torch.Tensor, d: int, dtype: torch.dtype) -> torch.Tensor:
    """``wq · d**-0.5 · log2(e)`` in fp32, rounded to ``dtype`` once."""
    return (wq.float() * (d**-0.5 * _LOG2E)).to(dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int) -> torch.Tensor:
    """Base-2 softmax attention over ``[B, N, H, D]`` with q pre-scaled, one
    head at a time: fp32 logits, key columns at or past ``kv_len`` masked
    with the fp32 minimum before the row max, P unnormalised and rounded to
    q's dtype before P·V, the fp32 sum divided by the row sum after it, each
    head's output rounded. Returns ``[B, N, H·D]``."""
    heads = q.shape[2]
    outs = []
    for h in range(heads):
        s = q[:, :, h].float() @ k[:, :, h].float().transpose(1, 2)   # [B, N, nk]
        if kv_len < s.shape[-1]:
            s[..., kv_len:] = torch.finfo(torch.float32).min
        m = s.amax(-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(-1, keepdim=True)
        o = (p.to(q.dtype).float() @ v[:, :, h].float()) / l
        outs.append(o.to(q.dtype))
    return torch.cat(outs, dim=-1)


def fused_block_plain(x, gamma, beta, wq, wk, wv, wo, bo, heads: int, d: int,
                      chunk: int = 1024) -> torch.Tensor:
    """X1's function in plain PyTorch at the TPU kernel's rounding points:
    ``bf16(bf16(attend(LN(x) Wq', LN(x) Wk, LN(x) Wv) Wo + bo) + x)`` in the
    working type ``x.dtype``, fp32 products."""
    dt = x.dtype
    b, n, c = x.shape
    with torch.autocast(x.device.type, enabled=False):
        xln = layer_norm_single_pass(x, gamma, beta).float()
        q = (xln @ _scaled_q(wq, d, dt).float()).to(dt).view(b, n, heads, d)
        k = (xln @ wk.to(dt).float()).to(dt).view(b, n, heads, d)
        v = (xln @ wv.to(dt).float()).to(dt).view(b, n, heads, d)
        y = _attend(q, k, v, n).float() @ wo.to(dt).float()
        return (y + bo.float()).to(dt) + x


def tail_attention_plain(x, g2, b2, wq, wo, bo, kc, vc, g3, b3, heads: int, d: int,
                         kv_len: int):
    """X2's attention half in plain PyTorch, what its attention launches
    write: ``x1 = bf16(bf16(attend(LN2(x) Wq', kc, vc) Wo + bo) + x)`` over
    the first ``kv_len`` of kc/vc's rows, and ``LN3(x1)``. Returns both."""
    dt = x.dtype
    b, n, c = x.shape
    nk = kc.shape[1]
    with torch.autocast(x.device.type, enabled=False):
        xln = layer_norm_single_pass(x, g2, b2).float()
        q = (xln @ _scaled_q(wq, d, dt).float()).to(dt).view(b, n, heads, d)
        att = _attend(q, kc.view(b, nk, heads, d), vc.view(b, nk, heads, d), kv_len)
        y = att.float() @ wo.to(dt).float()
        x1 = (y + bo.float()).to(dt) + x
        return x1, layer_norm_single_pass(x1, g3, b3)


def tail_fused_plain(x, g2, b2, wq, wo, bo, kc, vc, g3, b3, w1, b1, w2, bff, heads: int,
                     d: int, kv_len: int, block_q: int = 1024) -> torch.Tensor:
    """X2's function in plain PyTorch at the TPU kernel's rounding points:
    cross-attention over the first ``kv_len`` of kc/vc's rows, out-projection
    and residual (x1), then LN3 and the GEGLU (exact-erf GELU in fp32, h
    rounded), ``bf16(bf16(h W2 + bff) + x1)``. The products take the tool's
    ``[in, out]`` weights transposed, as ``F.linear`` takes them."""
    dt = x.dtype
    inner = w2.shape[0]
    x1, xln3 = tail_attention_plain(x, g2, b2, wq, wo, bo, kc, vc, g3, b3, heads, d, kv_len)
    with torch.autocast(x.device.type, enabled=False):
        s = F.linear(xln3.float(), w1.to(dt).float().t(), b1.float())
        a, g = s[..., :inner], s[..., inner:]
        h = (a * F.gelu(g)).to(dt)
        return F.linear(h.float(), w2.to(dt).float().t(), bff.float()).to(dt) + x1


def _check_no_grad(name: str, tensors) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: forward-only, as the TPU kernel is (it has no gradient); "
                           f"call it under torch.no_grad() or torch.inference_mode()")


def _check_common(name: str, x, heads: int, d: int, shapes: dict) -> None:
    """The checks a CUDA call meets before its launch (also run on CPU
    tensors by the tests): bf16 x [B, N, C] with C = heads · d and d a
    multiple of 8, and every tensor of ``shapes`` (label: (tensor, shape)) on
    x's device with its shape."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x is {x.dtype}; the card's path is bfloat16")
    if x.ndim != 3 or x.numel() == 0:
        raise ValueError(f"{name}: x must be a non-empty [B, N, C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if heads < 1 or d < 8 or d % 8 or heads * d != c:
        raise ValueError(f"{name}: C={c} must be heads·d with d a multiple of 8, got "
                         f"heads={heads}, d={d}")
    for label, (t, shape) in shapes.items():
        if t.device != x.device:
            raise ValueError(f"{name}: {label} is on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {label} is {tuple(t.shape)}, expected {shape}")


def _check_block(x, gamma, beta, wq, wk, wv, wo, bo, heads, d) -> None:
    c = x.shape[-1]
    if d > _X1_MAX_D or c > _X1_MAX_C:
        raise ValueError(f"fused_block: the kernels take d <= {_X1_MAX_D} (a warp's output "
                         f"rows in registers) and C <= {_X1_MAX_C} (a row's LayerNorm in a "
                         f"warp), got d={d}, C={c}")
    _check_common("fused_block", x, heads, d,
                  {**{k: (t, (c, c)) for k, t in dict(wq=wq, wk=wk, wv=wv, wo=wo).items()},
                   **{k: (t, (c,)) for k, t in dict(gamma=gamma, beta=beta, bo=bo).items()}})


def _check_tail(x, g2, b2, wq, wo, bo, kc, vc, g3, b3, w1, b1, w2, bff, heads, d,
                kv_len) -> None:
    b, c = x.shape[0], x.shape[-1]
    inner = w2.shape[0]
    nk = kc.shape[1] if kc.ndim == 3 else -1
    if d > _X1_MAX_D or c > _X1_MAX_C:
        raise ValueError(f"tail_fused: the attention launches (X1's) take d <= {_X1_MAX_D} and "
                         f"C <= {_X1_MAX_C}, got d={d}, C={c}")
    if inner < 8 or inner % 8:
        raise ValueError(f"tail_fused: inner={inner} must be a positive multiple of 8")
    if not 1 <= kv_len <= nk:
        raise ValueError(f"tail_fused: kv_len={kv_len} must be in [1, nk={nk}]")
    for name, t in (("kc", kc), ("vc", vc)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"tail_fused: {name} is {t.dtype}; the card's path is bfloat16")
    vecs = dict(g2=g2, b2=b2, bo=bo, g3=g3, b3=b3, bff=bff)
    _check_common("tail_fused", x, heads, d,
                  dict(wq=(wq, (c, c)), wo=(wo, (c, c)), kc=(kc, (b, nk, c)),
                       vc=(vc, (b, nk, c)), w1=(w1, (c, 2 * inner)), w2=(w2, (inner, c)),
                       b1=(b1, (2 * inner,)), **{k: (t, (c,)) for k, t in vecs.items()}))


def _vec(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _aligned(name: str, **tensors) -> None:
    for label, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} is not 16-byte aligned")


def _prepare_x1(wq, wk, wv, wo, d: int, dtype: torch.dtype):
    """X1's kernel weights: ``[Wq' | Wk | Wv]ᵀ [3C, C]`` (Wq' scaled as
    :func:`_scaled_q`) and ``Woᵀ [C, C]``, in ``dtype``, contiguous."""
    wqkv = torch.cat([_scaled_q(wq, d, dtype), wk.to(dtype), wv.to(dtype)], dim=1)
    return wqkv.t().contiguous(), wo.to(dtype).t().contiguous()


def _prepare_x2(wq, wo, w1, w2, d: int, dtype: torch.dtype):
    """X2's kernel weights in ``dtype``, contiguous, out x in: ``Wq'ᵀ`` and
    ``Woᵀ [C, C]``, ``W1ᵀ [2·inner, C]`` (value rows first, as K2 takes
    them) and ``W2ᵀ [C, inner]``."""
    return (_scaled_q(wq, d, dtype).t().contiguous(),
            *(w.to(dtype).t().contiguous() for w in (wo, w1, w2)))


def _kept(kind: str, prepare, sources, d: int, dtype: torch.dtype):
    """``prepare(*sources, d, dtype)``, made once per weight version and
    kept (the last ``_CACHE_SIZE`` weight sets of X1 and X2): a weight edited
    in place (its version counter) or replaced (another tensor) is prepared
    again, so a stale copy is never served."""
    versions = tuple(t._version for t in sources)
    for key, (refs, seen, prepared) in _weight_cache.items():
        if (key[:3] == (kind, d, dtype) and seen == versions
                and all(r() is t for r, t in zip(refs, sources))):
            _weight_cache.move_to_end(key)
            return prepared
    with torch.no_grad():
        prepared = prepare(*sources, d, dtype)
    key = (kind, d, dtype, tuple(id(t) for t in sources))
    _weight_cache[key] = (tuple(weakref.ref(t) for t in sources), versions, prepared)
    _weight_cache.move_to_end(key)
    while len(_weight_cache) > _CACHE_SIZE:
        _weight_cache.popitem(last=False)
    return prepared


def x1_weights(wq, wk, wv, wo, d: int, dtype: torch.dtype):
    """:func:`_prepare_x1` of the tool's ``[in, out]`` weights, kept per
    weight version (:func:`_kept`)."""
    return _kept("x1", _prepare_x1, (wq, wk, wv, wo), d, dtype)


def x2_weights(wq, wo, w1, w2, d: int, dtype: torch.dtype):
    """:func:`_prepare_x2` of the tool's ``[in, out]`` weights, kept per
    weight version (:func:`_kept`)."""
    return _kept("x2", _prepare_x2, (wq, wo, w1, w2), d, dtype)


def x1_plan(b: int, n: int, c: int, d: int) -> dict:
    """X1's plans at ``x [b, n, c]`` and head dim d, from the loaded library:
    launch A's (LN + QKV: rows a block, columns a tile, weight stages,
    blocks, column runs, tiles a block, shared memory bytes) and launch B's
    (attention + out-projection: query rows a block, keys a tile, padded
    head dim, output columns a step, weight stages, shared memory bytes,
    blocks resident per SM, threads, column splits, blocks). Needs the card."""
    out = (ctypes.c_int * 17)()
    check(kernels().sdt_fused_block_plan(b, n, c, d, out), f"fused_block plan at {(b, n, c, d)}")
    first = ("rows", "cols", "stages", "blocks", "runs", "tiles_per_block", "smem_bytes")
    second = ("rows", "keys", "head_dim", "cols", "stages", "smem_bytes", "blocks_per_sm",
              "threads", "column_splits", "blocks")
    return {"qkv": dict(zip(first, out[:7])), "attn": dict(zip(second, out[7:]))}


@functools.lru_cache(maxsize=64)
def _x2_plan(device: int, b: int, n: int, c: int, d: int, kv_len: int, inner: int) -> tuple:
    """The library's 33 plan values (``sdt_tail_fused_plan``), the last the
    fp32 elements of K2's k-split scratch."""
    out = (ctypes.c_int * 33)()
    with torch.cuda.device(device):
        err = kernels().sdt_tail_fused_plan(b, n, c, d, kv_len, inner, out)
    check(err, f"tail_fused plan at {(b, n, c, d, kv_len, inner)}")
    return tuple(out)


def x2_plan(b: int, n: int, c: int, d: int, kv_len: int, inner: int) -> dict:
    """X2's plans at ``x [b, n, c]``, head dim d, kv_len keys and inner, from
    the loaded library: launch 1's (LN2 + Q, X1's launch A), launch 2's
    (cross-attention + out-projection + residual, X1's launch B), whether
    LN3 takes a launch of its own (where launch 2 splits its columns), K2's
    plan of each GEMM and the fp32 elements of its k-split scratch. Needs
    the card."""
    v = _x2_plan(torch.cuda.current_device(), b, n, c, d, kv_len, inner)
    gemm = ("rows", "cols", "stages", "tiles", "blocks", "splits", "cluster")
    return {"q": dict(zip(("rows", "cols", "stages", "blocks", "runs", "tiles_per_block",
                           "smem_bytes"), v[:7])),
            "attn": dict(zip(("rows", "keys", "head_dim", "cols", "stages", "smem_bytes",
                              "blocks_per_sm", "threads", "column_splits", "blocks"), v[7:17])),
            "ln3_own_launch": bool(v[17]), "gemm1": dict(zip(gemm, v[18:25])),
            "gemm2": dict(zip(gemm, v[25:32])), "workspace": v[32]}


def fused_block(x, gamma, beta, wq, wk, wv, wo, bo, heads: int, d: int,
                chunk: int = 1024) -> torch.Tensor:
    """X1 over ``x [B, N, C]``: ``LN → QKV → heads-way softmax attention →
    ·Wo + bo + x``. Returns ``[B, N, C]`` in x's dtype. ``chunk``, the TPU
    kernel's key tile, is taken for the tool's signature and ignored."""
    args = (x, gamma, beta, wq, wk, wv, wo, bo)
    _check_no_grad("fused_block", args)
    if x.device.type == "cpu":
        return fused_block_plain(*args, heads, d, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block: no path for device {x.device}")
    _check_block(*args, heads, d)
    b, n, c = x.shape
    lib = kernels()
    if lib.sdt_fused_block_q(c, d) == 0:
        raise ValueError(f"fused_block: no row tile of the kernel fits C={c}, d={d}")
    dt = x.dtype
    x = x.contiguous()
    wqkv, wo = x1_weights(wq, wk, wv, wo, d, dt)
    gamma, beta, bo = _vec(gamma), _vec(beta), _vec(bo)
    qkv = torch.empty((b * n, 3 * c), dtype=dt, device=x.device)
    out = torch.empty_like(x)
    _aligned("fused_block", x=x, wqkv=wqkv, wo=wo)
    with torch.cuda.device(x.device):
        err = lib.sdt_fused_block(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                  wqkv.data_ptr(), wo.data_ptr(), bo.data_ptr(), qkv.data_ptr(),
                                  out.data_ptr(), b, n, c // d, d, stream_of(x))
    check(err, "fused_block")
    fused_block.launches += 1
    return out


fused_block.launches = 0


def tail_fused(x, g2, b2, wq, wo, bo, kc, vc, g3, b3, w1, b1, w2, bff, heads: int, d: int,
               kv_len: int, block_q: int = 1024) -> torch.Tensor:
    """X2 over ``x [B, N, C]``: ``LN2 → x·Wq → cross-attention over the first
    kv_len keys of kc/vc → ·Wo + bo + x → LN3 → GEGLU → ·W2 + bff + x1``.
    Returns ``[B, N, C]`` in x's dtype. ``block_q``, the TPU kernel's row
    tile, is taken for the tool's signature and ignored."""
    args = (x, g2, b2, wq, wo, bo, kc, vc, g3, b3, w1, b1, w2, bff)
    _check_no_grad("tail_fused", args)
    if x.device.type == "cpu":
        return tail_fused_plain(*args, heads, d, kv_len, block_q)
    if x.device.type != "cuda":
        raise ValueError(f"tail_fused: no path for device {x.device}")
    _check_tail(*args, heads, d, kv_len)
    b, n, c = x.shape
    nk = kc.shape[1]
    inner = w2.shape[0]
    dt = x.dtype
    ws_elems = _x2_plan(x.device.index, b, n, c, d, kv_len, inner)[-1]
    x, kc, vc = x.contiguous(), kc.contiguous(), vc.contiguous()
    wq, wo, w1, w2 = x2_weights(wq, wo, w1, w2, d, dt)
    g2, b2, bo, g3, b3, b1, bff = (_vec(t) for t in (g2, b2, bo, g3, b3, b1, bff))
    q, x1, xln3 = (torch.empty((b * n, c), dtype=dt, device=x.device) for _ in range(3))
    h = torch.empty((b * n, inner), dtype=dt, device=x.device)
    ws = torch.empty((ws_elems,), dtype=torch.float32, device=x.device) if ws_elems else None
    out = torch.empty_like(x)
    _aligned("tail_fused", x=x, kc=kc, vc=vc, wq=wq, wo=wo, w1=w1, w2=w2)
    with torch.cuda.device(x.device):
        err = kernels().sdt_tail_fused(
            x.data_ptr(), g2.data_ptr(), b2.data_ptr(), wq.data_ptr(), wo.data_ptr(),
            bo.data_ptr(), kc.data_ptr(), vc.data_ptr(), g3.data_ptr(), b3.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), bff.data_ptr(), q.data_ptr(),
            x1.data_ptr(), xln3.data_ptr(), h.data_ptr(),
            ws.data_ptr() if ws is not None else None, out.data_ptr(), b, n, nk, kv_len,
            c // d, d, inner, stream_of(x))
    check(err, "tail_fused")
    tail_fused.launches += 1
    return out


tail_fused.launches = 0


def block_weights(block, context: torch.Tensor):
    """The arguments of X1 and X2 for a port ``BasicTransformerBlock`` and its
    ``context [B, L, C_ctx]``: two keyword dicts, for :func:`fused_block` and
    :func:`tail_fused`. The ``nn.Linear`` weights are transposed to the
    tool's ``[in, out]``; ``attn2``'s ``to_k``/``to_v`` are applied to the
    context here (the one product outside the kernels) and the result is
    zero-padded to a multiple of 16 rows, with ``kv_len = L``. Weights are detached: the kernels are forward-only."""
    a1, a2, ff = block.attn1, block.attn2, block.ff
    for norm in (block.norm1, block.norm2, block.norm3):
        if norm.eps != _LN_EPS:
            raise ValueError(f"block_weights: the kernels' LayerNorm eps is {_LN_EPS}, the "
                             f"block's is {norm.eps}")
    heads, d = a1.heads, a1.dim_head
    t = lambda lin: lin.weight.detach().t()
    vec = lambda p: p.detach()
    x1 = dict(gamma=vec(block.norm1.weight), beta=vec(block.norm1.bias), wq=t(a1.to_q),
              wk=t(a1.to_k), wv=t(a1.to_v), wo=t(a1.to_out[0]), bo=vec(a1.to_out[0].bias),
              heads=heads, d=d)
    kv_len = context.shape[1]
    pad = (0, 0, 0, -kv_len % _KV_PAD)
    with torch.no_grad():
        kc = F.pad(a2.to_k(context), pad)
        vc = F.pad(a2.to_v(context), pad)
    proj, out = ff.net[0].proj, ff.net[2]
    x2 = dict(g2=vec(block.norm2.weight), b2=vec(block.norm2.bias), wq=t(a2.to_q),
              wo=t(a2.to_out[0]), bo=vec(a2.to_out[0].bias), kc=kc, vc=vc,
              g3=vec(block.norm3.weight), b3=vec(block.norm3.bias), w1=t(proj),
              b1=vec(proj.bias), w2=t(out), bff=vec(out.bias), heads=heads, d=d,
              kv_len=kv_len)
    return x1, x2
