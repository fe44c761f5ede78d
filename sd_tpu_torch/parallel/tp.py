"""Megatron tensor parallelism for the UNet over a mesh's ``model`` dim
(port of ``sd_tpu/parallel/tp.py``).

``sd_tpu`` expresses the layout as parameter ``PartitionSpec``s and lets
GSPMD place the collectives. Eager PyTorch has no GSPMD, so
:func:`parallelize_unet` cuts each rank's slices out of the weights and
puts the collectives in explicitly: after each row-parallel layer one
autograd-aware all-reduce (``torch.distributed.nn.functional.all_reduce``),
and the layer's bias is added once, after the sum. The rules and gates are
``sd_tpu``'s ``_RULES``, on the port's ``state_dict`` names
(:func:`unet_tp_plan`):

- attention ``attnN.to_q/k/v``: column-parallel (rows of ``[inner, C]``),
  ``to_out.0``: row-parallel. Sharded only where ``num_heads % n == 0``
  (``num_heads=None`` keeps attention replicated), so a rank holds whole
  heads: ``CrossAttention`` runs on ``heads / n`` heads, and K1 takes them
  as it takes any head count (SD v1 at n = 2: 4 heads of 40, 80, 160);
- the GEGLU feed-forward: ``ff.net.0.proj`` column-parallel, ``ff.net.2``
  row-parallel. A rank takes the matching rows of the value half AND of
  the gate half of ``proj`` (``[value_r | gate_r]``), so GEGLU stays local
  and K2 runs on each rank at inner / n (SD v1 at n = 2: 640, 1280, 2560),
  with a zero ``b2``: the real one is added after the all-reduce.
  ``sd_tpu`` instead shards ``proj``'s ``[value | gate]`` output dim as it
  lies, so the halves land on different devices; GSPMD reshards before the
  product, and ``unet_tp_specs`` turns its fused FF kernel off through
  ``SD_TPU_FUSED_FF=0``. The results are the same; the layout differs, and
  the port changes no environment variable;
- the ResBlock pair (only where ``32 % n == 0``): ``in_layers.2`` (conv)
  and ``emb_layers.1`` column-parallel on the output channels,
  ``out_layers.0``'s GroupNorm on the rank's C / n channels in 32 / n
  groups (exactly the full GroupNorm's statistics: the group boundaries
  align with the shards), ``out_layers.3`` (conv) row-parallel on its input
  channels. ``emb_layers.1`` is sharded only where its width is the conv's:
  ``use_scale_shift_norm`` doubles it, and then it stays replicated and the
  rank picks its own scale and shift columns from its output. The
  row-parallel conv is ``F.conv2d`` on the rank's input channels: a model
  whose blocks hold the fused conv mode (K7, ``SD_TPU_FUSED_CONV``) or
  whose convs hold the Winograd mode (K8, ``SD_TPU_CONV_IMPL``) is refused,
  as is the int8 serving mode, and a parallel block raises where either
  mode is turned on afterwards;
- everything else replicated, the UNet's output conv (``out.2``) included;
  a leaf whose sharded dim does not divide stays replicated.

``spatial_sharding`` (``sd_tpu``'s height-sharded activations, a halo
exchange that GSPMD derives) is not ported: it has no caller in ``sd_tpu``,
and eager PyTorch has no counterpart of the derivation.

Gradients. The backward of ``all_reduce`` all-reduces the gradient, so
each rank's ``backward`` computes the gradient of the SUM of the ranks'
(equal) losses: n times the gradient of the loss on the sharded weights,
and on a replicated weight this rank's part of that n-fold gradient.
:func:`reduce_tp_gradients` divides the first by n and sums the second over
the ranks (one all-reduce of them all) before dividing by n: then every
rank holds the loss's gradient, each sharded weight its slice of it.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from sd_tpu_torch.ops.attention import CrossAttention, FeedForward
from sd_tpu_torch.ops.conv import Conv3x3
from sd_tpu_torch.ops.cuda.fused_conv import fused_conv_enabled
from sd_tpu_torch.ops.norms import GroupNorm32
from sd_tpu_torch.ops.resblock import ResBlock
from sd_tpu_torch.parallel.mesh import axis_info

__all__ = ["unet_tp_plan", "parallelize_unet", "reduce_tp_gradients", "tp_all_reduce",
           "TPLayout", "RowParallelLinear", "RowParallelConv3x3"]


# (name regex, sharded dim of the torch weight), first hit wins
_RULES = (
    # attention projections: Linear weights [out, in]
    (re.compile(r"attn\d\.to_[qkv]\.weight$"), 0),          # column: heads
    (re.compile(r"attn\d\.to_out\.0\.weight$"), 1),          # row: all-reduce
    # GEGLU feed-forward
    (re.compile(r"ff\.net\.0\.proj\.(weight|bias)$"), 0),    # column, value and gate rows
    (re.compile(r"ff\.net\.2\.weight$"), 1),                 # row: all-reduce
    # the ResBlock pair (conv weights OIHW)
    (re.compile(r"in_layers\.2\.(weight|bias)$"), 0),        # column: out channels
    (re.compile(r"emb_layers\.1\.(weight|bias)$"), 0),       # column (aligned add)
    (re.compile(r"out_layers\.0\.(weight|bias)$"), 0),       # GroupNorm on local channels
    (re.compile(r"out_layers\.3\.weight$"), 1),              # row: in channels
)
_ATTN = ("to_q.", "to_k.", "to_v.", "to_out.")
_RESBLOCK = ("in_layers.", "emb_layers.", "out_layers.")


def _sharded_dim(name: str, shape, shapes: Mapping[str, Sequence[int]], n: int,
                 resblock_ok: bool, attn_ok: bool) -> Optional[int]:
    for rule, dim in _RULES:
        if not rule.search(name):
            continue
        if (not resblock_ok and any(t in name for t in _RESBLOCK)) or (
                not attn_ok and any(t in name for t in _ATTN)):
            return None
        if "emb_layers.1." in name:
            conv = name.rsplit("emb_layers.1.", 1)[0] + "in_layers.2.weight"
            if conv not in shapes or shapes[conv][0] != shape[0]:
                return None
        # the value and the gate half of proj each split
        size = shape[dim] // 2 if "ff.net.0.proj." in name else shape[dim]
        return dim if dim < len(shape) and size % n == 0 and size >= n else None
    return None


def unet_tp_plan(shapes: Mapping[str, Sequence[int]], n: int,
                 num_heads: Optional[int] = None) -> Dict[str, Optional[int]]:
    """Each UNet parameter's sharded dim over ``n`` ranks, or None where it
    stays replicated, from its name and shape (``shapes``: name → shape, as
    ``named_parameters`` gives them)."""
    resblock_ok = 32 % n == 0
    attn_ok = num_heads is not None and num_heads % n == 0
    return {name: _sharded_dim(name, shape, shapes, n, resblock_ok, attn_ok)
            for name, shape in shapes.items()}


def tp_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable (its
    backward all-reduces the gradient); ``tp_all_reduce.calls`` counts them."""
    from torch.distributed.nn.functional import all_reduce

    tp_all_reduce.calls += 1
    return all_reduce(x, group=group)


tp_all_reduce.calls = 0


def _slice(p: nn.Parameter, dim: int, r: int, n: int, halves: bool = False) -> nn.Parameter:
    """Rank ``r``'s block of ``n`` along ``dim`` (of each half, with ``halves``)."""
    parts = p.detach().chunk(2, dim) if halves else (p.detach(),)
    k = parts[0].shape[dim] // n
    out = torch.cat([t.narrow(dim, r * k, k) for t in parts], dim)
    return nn.Parameter(out.clone(), requires_grad=p.requires_grad)


class RowParallelLinear(nn.Linear):
    """``y = Σ_ranks x_r W_rᵀ + b``: this rank's input columns of the weight,
    one all-reduce, then the bias. :meth:`reduce` is the part after the
    product (FeedForward's K2 call makes the product)."""

    group: Any = None

    @classmethod
    def of(cls, lin: nn.Linear, r: int, n: int, group) -> "RowParallelLinear":
        new = cls(lin.in_features // n, lin.out_features, bias=lin.bias is not None,
                  device="meta")
        new.weight = _slice(lin.weight, 1, r, n)
        new.bias = lin.bias
        new.group = group
        return new

    def reduce(self, partial: torch.Tensor) -> torch.Tensor:
        y = tp_all_reduce(partial, self.group)
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduce(F.linear(x, self.weight))


class RowParallelConv3x3(Conv3x3):
    """The 3x3 conv on this rank's input channels (``F.conv2d``), one
    all-reduce, then the bias. Raises in the Winograd mode (K8)."""

    group: Any = None
    # read by ResBlock's fused path (K7), which refuses a parallel block
    tensor_parallel = True

    @classmethod
    def of(cls, conv: Conv3x3, r: int, n: int, group) -> "RowParallelConv3x3":
        new = cls(conv.in_channels // n, conv.out_channels)
        new.weight = _slice(conv.weight, 1, r, n)
        new.bias = conv.bias
        new.group = group
        return new.to(conv.weight.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "winograd":
            raise ValueError("a tensor-parallel ResBlock does not run the Winograd conv "
                             "mode (K8); tensor parallelism runs SD_TPU_CONV_IMPL=auto")
        y = tp_all_reduce(self._conv_forward(x, self.weight, None), self.group)
        return y + self.bias.to(y.dtype)[:, None, None]


class _LocalScaleShift(nn.Linear):
    """``use_scale_shift_norm``'s replicated ``emb_layers.1`` (``[2C, E]``),
    returning the rank's scale columns then its shift columns."""

    @classmethod
    def of(cls, lin: nn.Linear, r: int, n: int) -> "_LocalScaleShift":
        new = cls(lin.in_features, lin.out_features, device="meta")
        new.weight, new.bias = lin.weight, lin.bias
        c = lin.out_features // 2
        k = c // n
        own = torch.arange(r * k, (r + 1) * k, device=lin.weight.device)
        new.register_buffer("columns", torch.cat([own, own + c]), persistent=False)
        return new

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).index_select(-1, self.columns)


@dataclasses.dataclass
class TPLayout:
    """What :func:`parallelize_unet` did: the plan (name → sharded dim or
    None), the ``model`` dim's group, this rank's index and the size."""

    plan: Dict[str, Optional[int]]
    group: Any
    rank: int
    size: int


def _local_norm(norm: GroupNorm32, r: int, n: int) -> GroupNorm32:
    new = GroupNorm32(norm.num_channels // n, eps=norm.eps, num_groups=norm.num_groups // n)
    new.weight = _slice(norm.weight, 0, r, n)
    new.bias = _slice(norm.bias, 0, r, n)
    return new


def parallelize_unet(unet: nn.Module, mesh, num_heads: Optional[int] = None) -> TPLayout:
    """Cut ``unet`` (replicated, the same weights on every rank) down to this
    rank's Megatron shards over ``mesh``'s ``model`` dim, in place; ``num_heads``
    gates attention as ``sd_tpu``'s ``unet_tp_specs`` does. The parameter
    names stay the ``state_dict``'s. Refuses a model in the int8 serving
    mode (its weights are quantized per output channel of the whole
    matrix), and one in the fused conv (K7) or the Winograd (K8) mode, whose
    kernels add the bias (and K7 the skip) before a row-parallel conv's sum."""
    group, r, n = axis_info(mesh, "model")
    if any(getattr(m, "int8", None) is not None and m.int8.buckets for m in unet.modules()):
        raise ValueError("parallelize_unet: the model is in the int8 serving mode; tensor "
                         "parallelism runs bf16 and fp32 models")
    plan = unet_tp_plan({k: tuple(p.shape) for k, p in unet.named_parameters()}, n, num_heads)
    for name, m in unet.named_modules():
        if isinstance(m, ResBlock) and plan.get(f"{name}.in_layers.2.weight") is not None:
            if fused_conv_enabled(m.conv_impl):
                raise ValueError(f"parallelize_unet: {name} holds the fused conv mode (K7, "
                                 f"SD_TPU_FUSED_CONV={m.conv_impl}); tensor parallelism runs "
                                 f"the plain conv mode")
            if m.out_layers[3].impl == "winograd":
                raise ValueError(f"parallelize_unet: {name} holds the Winograd conv mode (K8, "
                                 f"SD_TPU_CONV_IMPL=winograd); tensor parallelism runs the "
                                 f"plain conv mode")
    for name, m in list(unet.named_modules()):
        pre = f"{name}." if name else ""
        if isinstance(m, CrossAttention) and plan.get(pre + "to_q.weight") is not None:
            if m.heads % n:
                raise ValueError(f"{name}: {m.heads} heads do not split over {n} ranks; "
                                 f"num_heads={num_heads} is not the model's")
            for lin in (m.to_q, m.to_k, m.to_v):
                lin.weight = _slice(lin.weight, 0, r, n)
                lin.out_features //= n
            m.heads //= n
            m.to_out[0] = RowParallelLinear.of(m.to_out[0], r, n, group)
        elif isinstance(m, FeedForward) and plan.get(pre + "net.0.proj.weight") is not None:
            proj = m.net[0].proj
            proj.weight = _slice(proj.weight, 0, r, n, halves=True)
            proj.bias = _slice(proj.bias, 0, r, n, halves=True)
            proj.out_features //= n
            m.net[2] = RowParallelLinear.of(m.net[2], r, n, group)
        elif isinstance(m, ResBlock) and plan.get(pre + "in_layers.2.weight") is not None:
            conv1 = m.in_layers[2]
            conv1.weight = _slice(conv1.weight, 0, r, n)
            conv1.bias = _slice(conv1.bias, 0, r, n)
            conv1.out_channels //= n
            emb = m.emb_layers[1]
            if plan.get(pre + "emb_layers.1.weight") is not None:
                emb.weight = _slice(emb.weight, 0, r, n)
                emb.bias = _slice(emb.bias, 0, r, n)
                emb.out_features //= n
            else:
                m.emb_layers[1] = _LocalScaleShift.of(emb, r, n)
            m.out_layers[0] = _local_norm(m.out_layers[0], r, n)
            m.out_layers[3] = RowParallelConv3x3.of(m.out_layers[3], r, n, group)
    return TPLayout(plan=plan, group=group, rank=r, size=n)


@torch.no_grad()
def reduce_tp_gradients(unet: nn.Module, layout: TPLayout) -> None:
    """Turn the gradients of a backward through the parallel UNet into the
    loss's (module docstring): the sharded weights' over n, the replicated
    weights' summed over the ranks (one all-reduce) over n."""
    replicated = []
    for name, p in unet.named_parameters():
        if p.grad is None:
            continue
        if layout.plan.get(name) is not None:
            p.grad.div_(layout.size)
        else:
            replicated.append(p.grad)
    if replicated and layout.size > 1:
        flat = torch._utils._flatten_dense_tensors(replicated)
        dist.all_reduce(flat, group=layout.group)
        flat.div_(layout.size)
        for g, f in zip(replicated, torch._utils._unflatten_dense_tensors(flat, replicated)):
            g.copy_(f)
