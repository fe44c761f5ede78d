"""The step-driven training loop (port of ``DataModuleFromConfig``,
``scale_learning_rate`` and ``Trainer.fit`` from ``sd_tpu/training/trainer.py``).

``Trainer.fit`` runs the steps, prints the loss and it/s every ``log_every``
steps, saves ``last.pt`` every ``ckpt_every`` steps, on exit and on an
exception, and resumes exactly: each step's random draws come from a
generator seeded with a function of (seed, step), and on resume the loader
is fast-forwarded to the restored step's (epoch, position), so a resumed run
reproduces the uninterrupted one. Image logging, validation with monitored
top-k checkpoints and the SIGUSR1 save are not ported.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict

import torch

from sd_tpu_torch.data.base import DataLoader
from sd_tpu_torch.data.synthetic import SyntheticImages
from sd_tpu_torch.utils.checkpoint import latest_checkpoint, restore_checkpoint, save_last

__all__ = ["DataModuleFromConfig", "Trainer", "scale_learning_rate", "step_seed"]

# dataset config targets the port can build
DATASETS = {"sd_tpu_torch.data.synthetic.SyntheticImages": SyntheticImages}


class DataModuleFromConfig:
    """The shuffled train loader from a dataset config node
    ``{"target": ..., "params": {...}}`` (validation waits)."""

    def __init__(self, batch_size: int, train: Dict):
        if train["target"] not in DATASETS:
            raise NotImplementedError(f"no dataset {train['target']!r} in the port")
        self.batch_size = batch_size
        dataset = DATASETS[train["target"]](**(train.get("params") or {}))
        self.loader = DataLoader(dataset, batch_size=batch_size, shuffle=True)

    def train_dataloader(self) -> DataLoader:
        return self.loader


def scale_learning_rate(base_lr: float, batch_size: int, n_devices: int) -> float:
    """``lr = ndev x bs x base_lr`` (gradient accumulation 1)."""
    lr = n_devices * batch_size * base_lr
    print(f"Setting learning rate to {lr:.2e} = {n_devices} (devices) * {batch_size} "
          f"(batchsize) * {base_lr:.2e} (base_lr)")
    return lr


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator: a function of (seed, step) only."""
    return (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + 0x5D0) % (1 << 63)


@dataclasses.dataclass
class Trainer:
    """``fit(state, data, resume)`` drives ``trainer_obj.train_step``."""

    trainer_obj: Any  # LDMTrainer
    logdir: str
    max_steps: int = 1000
    ckpt_every: int = 1000
    seed: int = 42
    log_every: int = 50

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.logdir, "checkpoints")

    def _meta(self) -> Dict[str, Any]:
        ldm = self.trainer_obj.ldm
        # the frozen stages are drawn again from the seed on this device type
        return {"seed": int(self.seed), "scale_factor": float(ldm.scale_factor),
                "frozen_device": self.trainer_obj.device.type}

    def fit(self, state, data: DataModuleFromConfig, resume: bool = False):
        """Run the loop to ``max_steps``; returns ``state`` (updated in place)."""
        os.makedirs(self.logdir, exist_ok=True)
        if resume and (path := latest_checkpoint(self.ckpt_dir)):
            meta = restore_checkpoint(path, state)
            print(f"Restored from {path} (step {meta.get('step')})")
        device = self.trainer_obj.device
        loader = data.train_dataloader()
        step = state.step
        # fast-forward the loader to the restored (epoch, position)
        skip = 0
        if step and len(loader):
            loader.epoch, skip = divmod(step, len(loader))
        t0, t0_step = time.perf_counter(), step
        try:
            while step < self.max_steps:
                for batch in loader:
                    if skip:
                        skip -= 1
                        continue
                    if step >= self.max_steps:
                        break
                    generator = torch.Generator(device).manual_seed(step_seed(self.seed, step))
                    aux = self.trainer_obj.train_step(state, batch, generator)
                    step = state.step
                    if step % self.log_every == 0:
                        loss = float(aux["loss"])
                        rate = (step - t0_step) / max(time.perf_counter() - t0, 1e-9)
                        print(f"step {step}: loss={loss:.4f} ({rate:.2f} it/s)")
                    if step % self.ckpt_every == 0:
                        save_last(self.ckpt_dir, state, self._meta())
        except BaseException:
            save_last(self.ckpt_dir, state, self._meta())
            raise
        save_last(self.ckpt_dir, state, self._meta())
        return state
