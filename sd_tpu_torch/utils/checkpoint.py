"""Training checkpoints (port of ``save_last``, ``save_monitored``,
``latest_checkpoint`` and restore from ``sd_tpu/utils/checkpoint.py``), and
run directories as inference inputs (its ``is_run_path``,
``resolve_run_checkpoint``, ``run_config_path``, ``load_run_params`` and
``filter_state_dict``).

A checkpoint is one ``torch.save`` file, in the single-process layout
whatever the number of ranks: the trainer state's
``state_dict`` (an LDM run's: the step, the UNet's and, where it trains,
the cond stage's weights, the optimizer, the LR schedule, the EMA shadow and
a learned logvar table; a first-stage run's: the autoencoder, the
discriminator with its BatchNorm statistics, both optimizers and the NLL's
logvar), and metadata (seed, scale_factor, step, and the device type the
frozen stages were drawn on).
The frozen stages are not in it: a resumed run, or a sampler loading the
run, rebuilds them from the config and the seed. ``<ckpt_dir>/last.pt`` is
the resume entry; ``save_monitored`` keeps the top k checkpoints by a
validation metric as ``<ckpt_dir>/step_<n>.pt``. A run directory
that cannot be resolved is an error: it never samples random weights.

Under data parallelism every rank calls the saves (``state_dict`` gathers
ZeRO-1's shards of the optimizer and the EMA shadow onto rank 0) and rank 0
alone writes; every rank restores from the whole file, and ZeRO-1 keeps its
own shard of it, so a checkpoint of N ranks resumes at any number.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from sd_tpu_torch.parallel.mesh import is_main_process

__all__ = ["COND_STAGE_PREFIX", "save_last", "save_monitored", "latest_checkpoint",
           "restore_checkpoint", "is_run_path", "resolve_run_checkpoint", "run_config_path",
           "load_run_params", "filter_state_dict"]


# the EMA shadow's names for a trained cond stage's parameters (the UNet's
# keep their own names, as in runs that train the UNet alone)
COND_STAGE_PREFIX = "cond_stage_model."


def _save(path: str, state, metadata: Optional[Dict[str, Any]]) -> str:
    """Write ``state.state_dict()`` and ``metadata`` (plus the step) to
    ``path``, atomically; on rank 0 alone (every rank gathers)."""
    sd = state.state_dict()
    if is_main_process():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        meta = {**(metadata or {}), "step": int(state.step)}
        torch.save({"state": sd, "meta": meta}, tmp)
        os.replace(tmp, path)
    return path


def save_last(ckpt_dir: str, state, metadata: Optional[Dict[str, Any]] = None) -> str:
    """Write the state to ``<ckpt_dir>/last.pt``; returns the path."""
    return _save(os.path.join(ckpt_dir, "last.pt"), state, metadata)


def save_monitored(ckpt_dir: str, state, metrics: Dict[str, float], monitor: Optional[str],
                   tracked: List[Tuple[float, str]], metadata: Optional[Dict[str, Any]] = None,
                   save_top_k: int = 3, mode: str = "min") -> Optional[str]:
    """Keep the ``save_top_k`` best checkpoints by ``metrics[monitor]``
    (lowest with ``mode`` "min", highest with "max"): write the state to
    ``<ckpt_dir>/step_<n>.pt`` with the metrics in its metadata, add
    ``(value, path)`` to ``tracked`` (the caller's list of this run's
    monitored saves) and delete the files that fall out of the top k.
    Nothing is saved where ``monitor`` is None or not in ``metrics``.
    Returns the path written, or None."""
    if monitor is None or monitor not in metrics:
        return None
    path = _save(os.path.join(ckpt_dir, f"step_{int(state.step)}.pt"), state,
                 {**(metadata or {}), "metrics": dict(metrics)})
    tracked[:] = [t for t in tracked if t[1] != path]  # this step saved again
    tracked.append((float(metrics[monitor]), path))
    tracked.sort(key=lambda t: t[0], reverse=mode == "max")
    while len(tracked) > save_top_k:
        _, drop = tracked.pop()
        if is_main_process() and os.path.isfile(drop):
            os.remove(drop)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """``<ckpt_dir>/last.pt`` if present, else None."""
    last = os.path.join(ckpt_dir, "last.pt")
    return last if os.path.isfile(last) else None


def restore_checkpoint(path: str, state, device) -> Dict[str, Any]:
    """Load a checkpoint onto ``device`` into ``state`` (in place); returns
    its metadata."""
    blob = torch.load(path, map_location=device, weights_only=True)
    state.load_state_dict(blob["state"])
    return blob["meta"]


def is_run_path(path: Optional[str]) -> bool:
    """Whether ``path`` names a training run's product (a directory holding
    ``checkpoints/`` or ``last.pt``), not a torch file."""
    if not path or not os.path.isdir(path):
        return False
    return (os.path.isdir(os.path.join(path, "checkpoints"))
            or os.path.isfile(os.path.join(path, "last.pt")))


def resolve_run_checkpoint(path: str) -> str:
    """The ``last.pt`` of a run logdir (``<logdir>/checkpoints/last.pt``) or
    of a checkpoint directory; raises ``FileNotFoundError`` otherwise."""
    path = os.path.abspath(path)
    for base in (os.path.join(path, "checkpoints"), path):
        if os.path.isdir(base) and (ckpt := latest_checkpoint(base)):
            return ckpt
    raise FileNotFoundError(
        f"{path!r} is not a loadable checkpoint: expected a run logdir with "
        f"checkpoints/last.pt or a directory holding last.pt (refusing to sample "
        f"random weights)")


def run_config_path(path: str) -> Optional[str]:
    """The config the run was trained with, ``<logdir>/configs/project.yaml``,
    looked for at ``path`` and up to two directories above it."""
    path = os.path.abspath(path)
    for d in (path, os.path.dirname(path), os.path.dirname(os.path.dirname(path))):
        cand = os.path.join(d, "configs", "project.yaml")
        if os.path.isfile(cand):
            return cand
    return None


def load_run_params(path: str, use_ema: bool = True
                    ) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Dict[str, Any]]:
    """The trained weights of an LDM run's checkpoint, on the CPU:
    ``{"unet": state_dict}`` and, where the run trained its cond stage,
    ``"cond_stage"``; the EMA shadow's values with ``use_ema`` where the run
    kept one (else the current parameters, with a note). Returns them and
    the metadata with ``params_source``."""
    ckpt = resolve_run_checkpoint(path)
    # mmap: only the tensors used are read from a file that also holds AdamW
    blob = torch.load(ckpt, map_location="cpu", weights_only=True, mmap=True)
    state = blob.get("state") if isinstance(blob, dict) else None
    if not isinstance(state, dict) or "unet" not in state:
        raise ValueError(f"checkpoint {ckpt!r} does not look like a trainer state")
    params = {"unet": state["unet"]}
    if state.get("cond_stage") is not None:
        params["cond_stage"] = state["cond_stage"]
    source = "current"
    if use_ema:
        ema = state.get("ema")
        if ema is not None and ema.get("shadow") is not None:
            shadow, source = ema["shadow"], "EMA"
            params["unet"] = {**params["unet"],
                              **{k: v for k, v in shadow.items() if k in params["unet"]}}
            if "cond_stage" in params:
                n = len(COND_STAGE_PREFIX)
                params["cond_stage"] = {**params["cond_stage"],
                                        **{k[n:]: v for k, v in shadow.items()
                                           if k.startswith(COND_STAGE_PREFIX)}}
        else:
            print(f"load_run_params: {ckpt} has no EMA shadow; using the current parameters",
                  flush=True)
    meta = dict(blob.get("meta") or {})
    meta["params_source"] = source
    return params, meta


def filter_state_dict(sd: Dict[str, Any], ignore_keys: Sequence[str] = ()) -> Dict[str, Any]:
    """``sd`` without the keys that start with any of ``ignore_keys``."""
    return {k: v for k, v in sd.items() if not any(k.startswith(ik) for ik in ignore_keys)}
