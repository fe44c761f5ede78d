"""Tracing, profiling and metrics (port of ``sd_tpu/utils/profiling.py``).

- :func:`count_params` (the reference's ``ldm/util.py`` ``count_params``).
- :func:`unet_flops`: the analytic forward FLOP count of a UNet from the
  port's block plan (``models/unet.py::build_unet_plan``), the same integer
  as ``sd_tpu``'s for a spatial-transformer config; it replaces the
  reference's thop hooks and is the count a share of the card's peak needs.
- :func:`trace` writes a ``torch.profiler`` Chrome trace of the block into
  a directory; :func:`annotate` names a region in it
  (``torch.profiler.record_function``).
- :class:`StepTimer` (steps/s over a window), :class:`MetricsWriter` (one
  JSON line per call in ``<logdir>/metrics.jsonl``, teed to a TensorBoard
  event file under ``<logdir>/tb``, ``utils/tb_events.py``) and
  :class:`WandbWriter` (raises at construction without the ``wandb``
  package, as ``sd_tpu``'s does).

``sd_tpu``'s ``start_profiler_server`` starts ``jax.profiler``'s server and
has no PyTorch counterpart, so the port has none.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["count_params", "unet_flops", "trace", "annotate", "StepTimer", "MetricsWriter",
           "WandbWriter"]


def count_params(model, verbose: bool = True, name: str = "model") -> int:
    """The elements of a module's parameters, or of a mapping's (or any
    iterable's) tensors and arrays; printed in millions with ``verbose``."""
    if isinstance(model, torch.nn.Module):
        tensors = list(model.parameters())
    elif isinstance(model, dict):
        tensors = list(model.values())
    else:
        tensors = list(model)
    n = sum(int(np.prod(t.shape)) for t in tensors)
    if verbose:
        print(f"{name} has {n * 1e-6:.2f} M params.")
    return n


def unet_flops(cfg, latent_hw: int, batch: int = 1) -> int:
    """The UNet's forward FLOPs at ``latent_hw`` x ``latent_hw`` latents:
    every 3x3 and 1x1 conv of the resnet blocks and resampling, each
    attention block's projections (3 in, 1 out) and its two products, the
    cross-attention against 77 context tokens, and the GEGLU FF, as
    ``sd_tpu``'s count walks its plan. The cross-attention term holds for
    77-token contexts only: it overstates a model with fewer context tokens
    (the RDM's 1 + k). A legacy attention block counts its
    width ``ch`` (``sd_tpu`` multiplies heads by a head width that may be
    -1 there)."""
    from sd_tpu_torch.models.unet import build_unet_plan

    plan = build_unet_plan(cfg)
    total = 0

    def conv_flops(h, cin, cout, k=3):
        return 2 * h * h * cin * cout * k * k

    def res_flops(h, ci, co):
        f = conv_flops(h, ci, co) + conv_flops(h, co, co)
        if ci != co:
            f += conv_flops(h, ci, co, k=1)
        return f

    def attn_flops(h, ch, d, ctx_len=None):
        n = h * h
        m = n if ctx_len is None else ctx_len
        f = 2 * n * ch * d * 3 + 2 * n * ch * d  # qkv + out proj
        f += 2 * 2 * n * m * d                    # scores + weighted sum
        return f

    def walk(blocks, h):
        nonlocal total
        for block in blocks:
            for desc in block if isinstance(block, list) else [block]:
                k = desc["kind"]
                if k == "conv_in":
                    total += conv_flops(h, cfg.in_channels, desc["ch"])
                elif k == "res":
                    total += res_flops(h, desc["ch"], desc["out_ch"])
                    if desc.get("down"):
                        h //= 2
                    if desc.get("up"):
                        h *= 2
                elif k == "attention":
                    total += attn_flops(h, desc["ch"], desc["ch"])
                elif k == "spatial_transformer":
                    d = desc["heads"] * desc["dim_head"]
                    total += attn_flops(h, desc["ch"], d)
                    total += attn_flops(h, desc["ch"], d, ctx_len=77)
                    total += 2 * (h * h) * desc["ch"] * desc["ch"] * 8  # GEGLU FF
                elif k == "downsample":
                    total += conv_flops(h // 2, desc["ch"], desc["ch"])
                    h //= 2
                elif k == "upsample":
                    h *= 2
                    total += conv_flops(h, desc["ch"], desc["ch"])
        return h

    h = walk(plan["input_blocks"], latent_hw)
    h = walk([plan["middle_block"]], h)
    walk(plan["output_blocks"], h)
    return total * batch


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (CPU activity, and the card's where
    there is one), its Chrome trace written to ``<logdir>/trace.json`` at
    the end; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if torch.cuda.is_available() else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named region in the profiler's trace (the UNet step, the decode ...)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Steps/s and s/step over each window of ``window`` steps (the
    reference's CUDACallback reports epoch time; wall time and rate are what
    every device gives)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0 = time.perf_counter()
        self._count = 0

    def step(self) -> Optional[Dict[str, float]]:
        self._count += 1
        if self._count % self.window:
            return None
        dt = time.perf_counter() - self._t0
        self._t0 = time.perf_counter()
        return {"steps_per_sec": self.window / dt, "sec_per_step": dt / self.window}


def _scalar(v) -> Optional[float]:
    """``v`` as a float where it is a scalar (a number, a 0-d array or
    tensor), else None."""
    if isinstance(v, torch.Tensor):
        return float(v.detach().float().cpu()) if v.ndim == 0 else None
    return float(np.asarray(v)) if np.ndim(v) == 0 else None


class MetricsWriter:
    """Append-only JSON lines (``{"step", "split", "time", <scalars>}``)
    in ``<logdir>/metrics.jsonl``, teed to a TensorBoard event file under
    ``<logdir>/tb`` (the reference's default logger is TensorBoard, through
    TestTube). Non-scalar values are dropped."""

    def __init__(self, logdir: str):
        from sd_tpu_torch.utils.tb_events import TensorBoardWriter

        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = TensorBoardWriter(os.path.join(logdir, "tb"))

    def write(self, step: int, metrics: Dict[str, Any], split: str = "train") -> None:
        row = {"step": int(step), "split": split, "time": time.time()}
        scalars = {}
        for k, v in metrics.items():
            value = _scalar(v)
            if value is not None:
                row[k] = scalars[k] = value
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if scalars:
            self._tb.write(step, scalars)

    def close(self) -> None:
        self._f.close()
        self._tb.close()


class WandbWriter:
    """An optional Weights & Biases sink (the reference offers a wandb
    logger beside TestTube): raises at construction where the ``wandb``
    package is missing; JSON lines and TensorBoard are the sinks the
    repository carries."""

    def __init__(self, project: str = "sd_tpu", run_name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None):
        import wandb  # noqa: F401 (a dependency of this sink only)

        self._run = wandb.init(project=project, name=run_name, config=config)

    def write(self, step: int, metrics: Dict[str, Any], split: str = "train") -> None:
        self._run.log({k: v for k, v in ((k, _scalar(v)) for k, v in metrics.items())
                       if v is not None}, step=int(step))

    def close(self) -> None:
        self._run.finish()
