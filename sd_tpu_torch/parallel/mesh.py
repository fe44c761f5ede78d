"""Process groups, the device mesh and data parallelism (port of
``sd_tpu/parallel/mesh.py``).

``sd_tpu`` places arrays on a ``jax.sharding.Mesh`` and GSPMD inserts the
collectives. Eager PyTorch has no GSPMD: the port runs one process per rank
(``torchrun``), and every collective is named in the code:

- :func:`init_distributed` joins the process group from ``torchrun``'s
  environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) on the backend the
  caller names, ``nccl`` on the card and ``gloo`` on the CPU, and returns
  the rank's device. ``gloo`` on the card is taken only where it is asked
  for: it is how several ranks share one card, which NCCL refuses;
- :func:`make_mesh`: the 2-D ``DeviceMesh`` with dims ``("data", "model")``;
- :func:`shard_batch`: a rank's contiguous block of rows, where
  ``P("data")`` puts them (sampling, the pipeline, tiling). The training
  loader shards by ``idx[rank::n]`` instead (``data/base.py``, as
  ``sd_tpu``'s), and the train step's draws follow it
  (``samplers/common.py::RowDraws``);
- :func:`shard_params`: parameters and buffers broadcast from rank 0
  (replicated, ``P()``);
- :func:`zero_sharding` / :func:`zero_optimizer` / :func:`zero_state_sharding`:
  ZeRO-1, the Adam or AdamW moments (the LDM's AdamW, the first stage's two
  Adams) and the EMA shadow partitioned over the data ranks, the
  parameters replicated; :func:`optimizer_state_dict` gathers an
  optimizer's shards into the single-process layout on rank 0 by tensor
  broadcasts from each parameter's owner (no pickles).
  ``torch.distributed.optim.ZeroRedundancyOptimizer``
  assigns WHOLE parameters to ranks (greedily, the largest first, each to
  the least loaded rank), where ``sd_tpu`` splits each leaf's largest
  divisible dimension: a rank holds at most its share of the moments' bytes
  plus the largest parameter's. The EMA shadow of a parameter lives on the
  rank that owns its moments;
- :func:`all_gather_rows`: each rank's rows of a batch, in rank order, on
  every rank;
- :func:`is_main_process`: rank 0, or no process group.

Reference: the CompVis trainer runs Lightning DDP over NCCL (``main.py:521``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "launched", "init_distributed", "world_size", "rank", "make_mesh",
           "axis_info", "shard_batch", "take_rows", "shard_params", "all_gather_rows",
           "zero_sharding", "zero_optimizer", "zero_owners", "zero_state_sharding",
           "optimizer_state_dict", "is_main_process"]

BACKENDS = ("nccl", "gloo")


def launched() -> bool:
    """Whether this process was started as one rank of a job (``torchrun``
    sets ``WORLD_SIZE``)."""
    return "WORLD_SIZE" in os.environ


def init_distributed(backend: str, device: str = "cuda",
                     init_method: Optional[str] = None) -> torch.device:
    """Join the job's process group on ``backend`` and return this rank's
    device: ``cuda:LOCAL_RANK`` (modulo the cards visible, where ``gloo``
    puts several ranks on one card), or the CPU where ``device`` says so.
    ``init_method`` defaults to ``env://`` (``torchrun``'s ``MASTER_ADDR``
    and ``MASTER_PORT``); ``file://<path>`` names a ``FileStore``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if not launched():
        raise ValueError("init_distributed: WORLD_SIZE is not set; start the ranks with "
                         "torchrun (python -m torch.distributed.run)")
    device_type = torch.device(device).type
    if backend == "nccl" and device_type != "cuda":
        raise ValueError(f"backend nccl needs CUDA devices, not {device!r}; use --backend gloo "
                         f"on the CPU")
    rank_ = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank_))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is available")
        cards = torch.cuda.device_count()
        if backend == "nccl" and local_world > cards:
            raise ValueError(f"{local_world} ranks on this host would share {cards} card(s): "
                             f"NCCL refuses two ranks on one GPU; run them with --backend gloo")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank_,
                                world_size=world)
    return dev


def world_size(group=None) -> int:
    """The ranks of ``group`` (the whole job by default); 1 without a process group."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def is_main_process() -> bool:
    """The reference's ``rank_zero_only``: rank 0 of the job, or a process
    that joined no group."""
    return rank() == 0


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device_type: str = "cuda"):
    """The ``("data", "model")`` ``DeviceMesh`` over the job's ranks;
    ``n_data`` defaults to the ranks over ``n_model``."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"{n_data}x{n_model} != {world} ranks")
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))


def axis_info(mesh, axis: str = "data") -> Tuple[Any, int, int]:
    """``(group, this rank's index, size)`` of ``mesh``'s ``axis``;
    ``(None, 0, 1)`` without a mesh."""
    if mesh is None:
        return None, 0, 1
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def take_rows(tree, index: int, count: int):
    """Block ``index`` of ``count`` equal blocks of rows of every array (or
    list) in ``tree`` (a dict, list or tuple of them, or one); refuses a
    batch that ``count`` does not divide."""
    if isinstance(tree, dict):
        return {k: take_rows(v, index, count) for k, v in tree.items()}
    if tree is None:
        return None
    b = len(tree)
    if b % count:
        raise ValueError(f"batch {b} does not divide into {count} ranks")
    k = b // count
    return tree[index * k:(index + 1) * k]


def shard_batch(mesh, batch, axis: str = "data"):
    """This rank's rows of ``batch`` (``P(axis)``): the contiguous block
    ``[r·B/n, (r+1)·B/n)`` of each entry."""
    _, index, count = axis_info(mesh, axis)
    return take_rows(batch, index, count)


@torch.no_grad()
def shard_params(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Replicate ``module``'s parameters and buffers: rank 0's, broadcast."""
    if world_size(group) > 1:
        src = 0 if group is None else dist.get_global_rank(group, 0)
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return module


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated in rank order along
    dim 0, on every rank: one all-gather. gloo takes no all-gather of CUDA
    tensors (several ranks on one card), so there it is the all-reduce (sum)
    of each rank's rows placed in a zero tensor of the whole batch: exact,
    since each element has one non-zero term, at twice the traffic."""
    n = world_size(group)
    if n == 1:
        return t
    b = t.shape[0]
    t = t.contiguous()
    if t.is_cuda and dist.get_backend(group) == "gloo":
        full = t.new_zeros((b * n,) + tuple(t.shape[1:]))
        r = rank(group)
        full[r * b:(r + 1) * b] = t
        dist.all_reduce(full, group=group)
        return full
    full = t.new_empty((b * n,) + tuple(t.shape[1:]))
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(full, t, group=group)
    return full


# the hyperparameters a ZeRO-1 optimizer takes over from the one it replaces
ZERO_HYPER = ("lr", "betas", "eps", "weight_decay")


def zero_sharding(params, group=None, optimizer_class=torch.optim.AdamW, **defaults):
    """ZeRO-1 ``optimizer_class`` (AdamW by default, or Adam) over ``params``
    (``ZeroRedundancyOptimizer``): each rank keeps the moments of the
    parameters it owns, steps them, and broadcasts them to the others."""
    from torch.distributed.optim import ZeroRedundancyOptimizer

    return ZeroRedundancyOptimizer(params, optimizer_class=optimizer_class,
                                   process_group=group, **defaults)


def zero_optimizer(optimizer: torch.optim.Optimizer, group=None):
    """ZeRO-1 of an Adam or AdamW before its first step: its class over the
    same parameters with the same LR, betas, eps and weight decay."""
    if any(optimizer.state.values()):
        raise ValueError("zero_optimizer: the optimizer has taken a step")
    params = [p for g in optimizer.param_groups for p in g["params"]]
    return zero_sharding(params, group, type(optimizer),
                         **{k: optimizer.defaults[k] for k in ZERO_HYPER})


def _zero_marks(optimizer) -> Tuple[List[int], List[bool], List[float]]:
    """Of each parameter of a ``ZeroRedundancyOptimizer``, in the order of
    its ``param_groups``: the owning rank, whether the owner holds state for
    it, and the owner's step count; read from each rank's local optimizer
    and summed over the ranks (one all-reduce)."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    owned = {id(p) for g in optimizer.optim.param_groups for p in g["params"]}
    me = rank(optimizer.process_group)
    rows = []
    for p in params:
        st = optimizer.optim.state.get(p) if id(p) in owned else None
        rows.append([me + 1 if id(p) in owned else 0, 1 if st else 0,
                     float(st["step"]) if st else 0.0])
    mark = torch.tensor(rows, dtype=torch.float64, device=params[0].device)
    dist.all_reduce(mark, group=optimizer.process_group)
    owners = [int(o) - 1 for o in mark[:, 0].tolist()]
    if min(owners) < 0:
        raise RuntimeError("zero_owners: a parameter has no owner")
    return owners, [bool(x) for x in mark[:, 1].tolist()], mark[:, 2].tolist()


def zero_owners(optimizer) -> List[int]:
    """The owning rank of each parameter of a ``ZeroRedundancyOptimizer``,
    in the order of its ``param_groups`` (one all-reduce)."""
    return _zero_marks(optimizer)[0]


def _step_dtype(group: Dict[str, Any]) -> torch.dtype:
    """The dtype of Adam's ``step`` (``torch.optim``'s rule): float32 when
    fused, else float64 only where that is the default dtype."""
    if group.get("fused") or torch.get_default_dtype() != torch.float64:
        return torch.float32
    return torch.float64


def optimizer_state_dict(optimizer: torch.optim.Optimizer,
                         device="cpu") -> Optional[Dict[str, Any]]:
    """The optimizer's ``state_dict`` in the single-process layout; every
    rank calls it, and under ZeRO-1 rank 0 alone gets it (the others None).

    A ``ZeroRedundancyOptimizer`` (over Adam or AdamW, the port's) is
    gathered by tensors: one all-reduce of each parameter's owner, state
    flag and step, then each parameter's moments broadcast by its owner and
    kept by rank 0 on ``device`` (the CPU by default). The result equals, to
    the bit, ``consolidate_state_dict(to=0)`` then ``state_dict()``, whose
    object collectives pickle every rank's whole state."""
    if not hasattr(optimizer, "consolidate_state_dict"):
        return optimizer.state_dict()
    if not isinstance(optimizer.optim, torch.optim.Adam):  # AdamW is an Adam
        raise TypeError(f"optimizer_state_dict: ZeRO-1 over {type(optimizer.optim).__name__}; "
                        f"the tensor gather knows Adam's and AdamW's state")
    group = optimizer.process_group
    me = rank(group)
    owners, stepped, steps = _zero_marks(optimizer)
    out = torch.optim.Optimizer.state_dict(optimizer) if me == 0 else None
    pending = False  # rank 0's own moments copied to the host asynchronously
    i = 0
    for g in optimizer.param_groups:
        keys = ("exp_avg", "exp_avg_sq") + (("max_exp_avg_sq",) if g.get("amsgrad") else ())
        for p in g["params"]:
            if stepped[i]:
                mine = optimizer.optim.state[p] if owners[i] == me else None
                src = dist.get_global_rank(group, owners[i])
                entry = {"step": torch.tensor(steps[i], dtype=_step_dtype(g), device=device)}
                for key in keys:
                    t = mine[key] if mine is not None else torch.empty_like(p)
                    dist.broadcast(t, src=src, group=group)
                    # a live moment copies into pinned memory without a sync
                    # (the received buffers, freed at once, copy in turn)
                    entry[key] = t.to(device, non_blocking=mine is not None)
                    pending |= mine is not None and t.is_cuda
                if me == 0:
                    out["state"][i] = entry
            i += 1
    if me != 0:
        return None
    if pending:
        torch.cuda.synchronize()
    out["state"] = dict(sorted(out["state"].items()))
    return out


def zero_state_sharding(state, group=None):
    """ZeRO-1 for a trainer state before its first step: its AdamW becomes a
    ``ZeroRedundancyOptimizer`` over the same parameters with the same LR,
    betas, eps and weight decay (its LR schedule rebound), and its EMA
    shadow keeps the owned parameters' tensors alone. In place; returns
    ``state``."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    zero = zero_optimizer(state.optimizer, group)
    if state.scheduler is not None:
        state.scheduler = torch.optim.lr_scheduler.LambdaLR(zero, state.scheduler.lr_lambdas[0])
    state.optimizer = zero
    if state.ema is not None:
        owner_of: Dict[int, int] = dict(zip(map(id, params), zero_owners(zero)))
        state.ema.shard({name: owner_of[id(p)] for name, p in state.trainables().items()},
                        group)
    return state
