"""The step-driven training loop (port of ``DataModuleFromConfig``,
``scale_learning_rate``, ``log_images``, ``log_images_vae``, ``ImageLogger``
and ``Trainer`` from ``sd_tpu/training/trainer.py``).

``Trainer`` drives either trainer: the LDM's (``LDMTrainer``) or the first
stage's (``VAEGANTrainer``, KL or VQ), whose state holds both optimizers,
the discriminator's BatchNorm statistics and the KL loss's logvar. For an LDM
whose trainer has ``scale_by_std``, a fresh run first sets ``scale_factor``
from the first train batch (a resumed run takes it from its checkpoint).

``Trainer.fit`` runs the steps, prints the loss and it/s every ``log_every``
steps (and writes them, ``train/loss`` and ``train/it_per_sec``, through
its ``metrics_writer`` where it has one, as does validation its metrics:
``utils/profiling.py``'s ``MetricsWriter``), and after a step: logs images where the ``ImageLogger``'s cadence
says so, saves ``last.pt`` every ``ckpt_every`` steps or when SIGUSR1 asked
for it (the reference's "melk" save), and every ``val_every`` steps runs
validation with the current UNet and the EMA shadow, keeping the top 3
checkpoints by the ``monitor`` metric. It saves ``last.pt`` on exit and on
an exception, and resumes exactly: each step's random draws come from a
generator seeded with a function of (seed, step), and on resume the loader
is fast-forwarded to the restored step's (epoch, position), so a resumed run
reproduces the uninterrupted one. Image logging and validation draw from
generators of their own, seeded from (seed, step) too, so they change
nothing of the training run. They run with the UNet in ``eval()`` under
``no_grad`` and the train step's autocast (bf16 on the card, where the
kernels run), and give it back in ``train()``.

The image logger logs an LDM's :func:`log_images` or a first stage's
:func:`log_images_vae` (its latents drawn from the logger's generator).

Under data parallelism (a trainer with a ``data_group``, under
``torchrun``: the LDM's or the first stage's) every rank runs the loop on
its shard of the data; rank 0
alone prints, logs images, writes metrics and writes checkpoints (every
rank takes part in a save: ZeRO-1's shards are gathered), validation's
losses are averaged over the ranks (so they are one process's at N times
the batch), and a SIGUSR1 that reaches any rank saves at the end of that
step on all: the flag is all-reduced each step over a gloo group of its
own, on the host, so that the step waits for no device. A save on an
exception is one process's only: a rank that failed cannot count on the
others to join the gather.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from sd_tpu_torch.core.distributions import DiagonalGaussian
from sd_tpu_torch.data.base import DataLoader
from sd_tpu_torch.models.vae import AutoencoderKL, VQModel
from sd_tpu_torch.parallel.mesh import is_main_process, world_size
from sd_tpu_torch.samplers.ancestral import progressive_denoising
from sd_tpu_torch.samplers.common import randn
from sd_tpu_torch.samplers.ddim import ddim_sample
from sd_tpu_torch.training.diffusion_loss import cond_to_device, rows
from sd_tpu_torch.training.ema import ema_scope
from sd_tpu_torch.training.vae_gan import latent_shape
from sd_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_last,
    save_monitored,
)
from sd_tpu_torch.utils.image import make_grid, save_image, segmentation_to_rgb, text_to_image

__all__ = ["DataModuleFromConfig", "ImageLogger", "Trainer", "log_images", "log_images_vae",
           "scale_learning_rate", "step_seed"]

# validation losses per pass: at most this many batches
VAL_BATCHES = 8
# the generator streams beside training's: image logging, validation, and
# (at step 0) scale_by_std's calibration
LOG_STREAM, VAL_STREAM, CAL_STREAM = 1, 2, 3


class DataModuleFromConfig:
    """The shuffled train loader and the validation loader (in order) from
    dataset config nodes ``{"target": ..., "params": {...}}``, built through
    the config registry, over rank ``shard_index``'s shard of ``num_shards``. ``num_workers`` and ``wrap``, which the published
    configs give, are taken and not used, as in ``sd_tpu``: one thread
    prefetches each loader's batches."""

    def __init__(self, batch_size: int, train: Dict, validation: Optional[Dict] = None,
                 num_workers: Optional[int] = None, wrap: bool = False, num_shards: int = 1,
                 shard_index: int = 0):
        from sd_tpu_torch.utils.config import instantiate_from_config

        self.batch_size = batch_size
        self.loaders = {}
        for split, cfg in (("train", train), ("validation", validation)):
            if cfg is None:
                continue
            dataset = instantiate_from_config(cfg)
            self.loaders[split] = DataLoader(dataset, batch_size=batch_size,
                                             shuffle=split == "train", num_shards=num_shards,
                                             shard_index=shard_index)

    def train_dataloader(self) -> DataLoader:
        return self.loaders["train"]

    def val_dataloader(self) -> Optional[DataLoader]:
        return self.loaders.get("validation")


def scale_learning_rate(base_lr: float, batch_size: int, n_devices: int,
                        scale: bool = True) -> float:
    """``lr = ndev x bs x base_lr`` (gradient accumulation 1; ``ndev`` the
    data-parallel ranks, ``bs`` a rank's batch); ``base_lr`` as it is
    without ``scale``."""
    if not scale:
        return base_lr
    lr = n_devices * batch_size * base_lr
    if is_main_process():
        print(f"Setting learning rate to {lr:.2e} = {n_devices} (devices) * {batch_size} "
              f"(batchsize) * {base_lr:.2e} (base_lr)")
    return lr


def step_seed(seed: int, step: int, stream: int = 0) -> int:
    """The seed of step ``step``'s generator: a function of (seed, step)
    only; ``stream`` 0 is the train step's, others are side streams."""
    return (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9 + 0x5D0
            + stream * 0x94D049BB133111EB) % (1 << 63)


@torch.no_grad()
def log_images(ldm, batch: Mapping[str, Any], generator: Optional[torch.Generator] = None,
               n_row: int = 4, sample_steps: int = 20, plot_denoise_rows: bool = False,
               noise: Optional[Mapping[str, Any]] = None) -> Dict[str, np.ndarray]:
    """The LDM ``log_images`` contract: named NHWC float32 image arrays in
    [-1, 1] of the batch's first ``n_row`` images: ``inputs``,
    ``reconstruction`` (a posterior sample decoded), ``conditioning`` (string
    captions drawn as images; they give no samples), ``original_conditioning``
    (a segmentation map's colours), ``diffusion_row`` (the latents noised to
    six timesteps from 0 to T-1 with one noise, decoded, as one grid),
    ``samples`` (DDIM ``sample_steps`` from the batch's conditioning, or
    unconditional for a model without a conditioning key) and, with
    ``plot_denoise_rows``, ``denoise_row``
    (the ancestral chain's x0 estimates from the samples' x_T every T/6
    steps, as one grid).

    Draws, in this order, from ``generator`` or from ``noise`` (NHWC, by
    name): ``posterior`` (none for an identity first stage), ``diffusion``,
    ``sample`` (the x_T of both chains) and ``denoise_steps`` (the ancestral
    chain's per-step noise)."""
    device = next(ldm.parameters()).device
    given = noise or {}
    nchw = lambda a: torch.as_tensor(np.array(a), device=device).permute(0, 3, 1, 2)
    nhwc = lambda t: t.float().permute(0, 2, 3, 1).cpu().numpy()

    def draw(name, like):
        return nchw(given[name]) if name in given else randn(like.shape, generator, device)

    out: Dict[str, np.ndarray] = {}
    n = min(n_row, len(batch["image"]))
    x = np.asarray(batch["image"][:n], dtype=np.float32)
    out["inputs"] = x
    encoding = ldm.encode_first_stage(nchw(x))
    if isinstance(encoding, DiagonalGaussian):
        encoding = encoding.sample(noise=draw("posterior", encoding.mean))
    z = ldm.scale_factor * encoding
    out["reconstruction"] = nhwc(ldm.decode_first_stage(z))

    raw_cond = batch.get(ldm.cond_stage_key)
    cond = None
    if raw_cond is not None and ldm.cond_stage_model is not None:
        if isinstance(raw_cond, list) and isinstance(raw_cond[0], str):
            # host strings need a tokenizer; the pipelines own it
            out["conditioning"] = text_to_image((x.shape[2] * 4, x.shape[1] * 4), raw_cond[:n])
        else:
            cond = ldm.get_learned_conditioning(cond_to_device(rows(raw_cond, 0, n), device))
            rc = None if isinstance(raw_cond, Mapping) else np.asarray(raw_cond[:n])
            if rc is not None and rc.ndim == 4 and rc.shape[-1] > 3:  # a segmentation map
                out["original_conditioning"] = segmentation_to_rgb(rc)

    z = z.float()
    z_noise = draw("diffusion", z).to(z.dtype)
    noised = []
    for t_frac in np.linspace(0, ldm.schedule.num_timesteps - 1, 6):
        t = torch.full((n,), int(t_frac), dtype=torch.long, device=device)
        noised.append(nhwc(ldm.decode_first_stage(ldm.q_sample(z, t, z_noise))))
    out["diffusion_row"] = make_grid(np.concatenate(noised), n_rows=n)[None]

    if cond is not None or ldm.conditioning_key is None:
        x_T = draw("sample", z).to(z.dtype)
        z_samp = ddim_sample(ldm.apply_model, ldm.schedule, x_T, cond, num_steps=sample_steps)
        out["samples"] = nhwc(ldm.decode_first_stage(z_samp))
        if plot_denoise_rows:
            steps = given.get("denoise_steps")
            _, x0_traj = progressive_denoising(
                ldm.apply_model, ldm.schedule, z.shape, cond=cond, generator=generator,
                x_T=x_T, log_every_t=ldm.schedule.num_timesteps // 6,
                noise=None if steps is None else [nchw(s) for s in steps])
            decoded = [nhwc(ldm.decode_first_stage(t)) for t in x0_traj]
            out["denoise_row"] = make_grid(np.concatenate(decoded), n_rows=n)[None]
    return out


@torch.no_grad()
def log_images_vae(model, batch: Mapping[str, Any], noise: torch.Tensor,
                   n_row: int = 4) -> Dict[str, np.ndarray]:
    """The first stage's ``log_images`` contract: NHWC float32 arrays in
    [-1, 1] of the batch's first ``n_row`` images: ``inputs``,
    ``reconstructions`` (KL: a posterior sample decoded; VQ: the codes
    decoded) and ``samples`` (the decode of standard normal latents, through
    the codebook for a VQ model); ``noise`` (NCHW, the latent's shape) is
    both the posterior sample's draw and the latents, as ``sd_tpu`` draws
    both from one key."""
    device = model.get_last_layer().device
    n = min(n_row, len(batch["image"]))
    x = np.asarray(batch["image"][:n], dtype=np.float32)
    noise = noise[:n].to(device)
    images = torch.as_tensor(x, device=device).permute(0, 3, 1, 2)
    rec = model(images)[0] if isinstance(model, VQModel) else model(images, noise=noise)[0]
    nhwc = lambda t: t.float().permute(0, 2, 3, 1).cpu().numpy()
    return {"inputs": x, "samples": nhwc(model.decode(noise)), "reconstructions": nhwc(rec)}


class ImageLogger:
    """Image logging every ``every`` steps and, with ``log_first_n``, at
    steps 1, 2, 4 and 8: each of :func:`log_images`' arrays (an LDM's) or
    :func:`log_images_vae`'s (a first stage's, its latents drawn from the
    generator) as one PNG grid,
    ``<logdir>/images/{split}_{name}_step{step:08}.png``."""

    def __init__(self, logdir: str, every: int = 750, max_images: int = 4,
                 log_first_n: bool = True):
        self.dir = os.path.join(logdir, "images")
        self.every = every
        self.max_images = max_images
        self.log_first_n = log_first_n
        os.makedirs(self.dir, exist_ok=True)

    def should_log(self, step: int) -> bool:
        if step % self.every == 0:
            return True
        return self.log_first_n and step <= 8 and (step & (step - 1)) == 0

    def __call__(self, model, batch: Mapping[str, Any], step: int,
                 generator: Optional[torch.Generator] = None, split: str = "train") -> List[str]:
        """Log ``batch`` at ``step`` through ``model`` (an LDM, or a KL or VQ
        first stage) where the cadence says so; returns the paths written."""
        if not self.should_log(step):
            return []
        if isinstance(model, (AutoencoderKL, VQModel)):
            n = min(self.max_images, len(batch["image"]))
            noise = randn(latent_shape(model, (n,) + np.shape(batch["image"])[1:]), generator,
                          model.get_last_layer().device)
            images = log_images_vae(model, batch, noise, n_row=self.max_images)
        else:
            images = log_images(model, batch, generator, n_row=self.max_images)
        paths = []
        for name, arr in images.items():
            grid = make_grid(np.clip((arr + 1.0) / 2.0, 0, 1))
            path = os.path.join(self.dir, f"{split}_{name}_step{step:08}.png")
            save_image((grid * 255).astype(np.uint8), path)
            paths.append(path)
        return paths


@dataclasses.dataclass
class Trainer:
    """``fit(state, data, resume)`` drives ``trainer_obj.train_step``. The
    image logger takes either trainer's model; validation is the LDM's."""

    trainer_obj: Any  # LDMTrainer or VAEGANTrainer
    logdir: str
    max_steps: int = 1000
    ckpt_every: int = 1000
    seed: int = 42
    log_every: int = 50
    val_every: int = 0
    monitor: Optional[str] = None
    image_logger: Optional[ImageLogger] = None
    # e.g. utils.profiling.MetricsWriter: logged steps and validations
    metrics_writer: Optional[Any] = None
    # this run's monitored checkpoints, (metric, path), best first
    monitored: List[Tuple[float, str]] = dataclasses.field(default_factory=list, init=False)
    # set by SIGUSR1: save last.pt at the end of the step
    melk_requested: bool = dataclasses.field(default=False, init=False)

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.logdir, "checkpoints")

    @property
    def ldm(self):
        """The LDM of an LDM trainer, else None."""
        return getattr(self.trainer_obj, "ldm", None)

    @property
    def data_group(self):
        """The trainer's data-parallel process group, else None."""
        return getattr(self.trainer_obj, "data_group", None)

    def _melk_agreed(self, group) -> bool:
        """Whether a SIGUSR1 reached any rank of ``group`` (a gloo group
        over every rank: one all-reduce of a CPU tensor), or this process's
        flag where ``group`` is None."""
        if group is None:
            return self.melk_requested
        flag = torch.tensor([int(self.melk_requested)])
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX, group=group)
        return bool(flag.item())

    def _meta(self) -> Dict[str, Any]:
        # the frozen stages are drawn again from the seed on this device type
        meta = {"seed": int(self.seed), "frozen_device": self.trainer_obj.device.type}
        if self.ldm is not None:
            meta["scale_factor"] = float(self.ldm.scale_factor)
        return meta

    def _melk(self, *args) -> None:
        print("Summoning checkpoint (SIGUSR1).", flush=True)
        self.melk_requested = True

    @contextlib.contextmanager
    def _eval_scope(self):
        """The trained modules in ``eval()`` under ``no_grad`` and the train
        step's autocast; back in ``train()`` afterwards."""
        modules = self.trainer_obj.trained_modules()
        for module in modules:
            module.eval()
        try:
            with torch.no_grad(), self.trainer_obj.autocast():
                yield
        finally:
            for module in modules:
                module.train()

    def _generator(self, step: int, stream: int) -> torch.Generator:
        return torch.Generator(self.trainer_obj.device).manual_seed(
            step_seed(self.seed, step, stream))

    def fit(self, state, data: DataModuleFromConfig, resume: bool = False):
        """Run the loop to ``max_steps``; returns ``state`` (updated in place)."""
        if is_main_process():
            os.makedirs(self.logdir, exist_ok=True)
        device = self.trainer_obj.device
        main = is_main_process()
        restored = False
        if resume and (path := latest_checkpoint(self.ckpt_dir)):
            meta = restore_checkpoint(path, state, device)
            restored = True
            if main:
                print(f"Restored from {path} (step {meta.get('step')})")
            if self.ldm is not None and meta.get("scale_factor") is not None:
                self.ldm.scale_factor = float(meta["scale_factor"])
        loader = data.train_dataloader()
        if getattr(self.trainer_obj, "scale_by_std", False) and not restored:
            # the first train batch, encoded at scale 1
            self.trainer_obj.calibrate_scale_by_std(loader.batch(0),
                                                    self._generator(0, CAL_STREAM))
        step = state.step
        # fast-forward the loader to the restored (epoch, position); a data
        # module's generator of batches (BatchResizeWrapper) is not
        skip = 0
        if step and hasattr(loader, "epoch") and len(loader):
            loader.epoch, skip = divmod(step, len(loader))
        # every rank runs the loop under data parallelism: the group spans them
        signals = (torch.distributed.new_group(backend="gloo")
                   if self.data_group is not None and world_size() > 1 else None)
        try:
            previous = signal.signal(signal.SIGUSR1, self._melk)
        except ValueError:  # not the main thread: no melk save
            previous = None
        t0, t0_step = time.perf_counter(), step
        try:
            while step < self.max_steps:
                for batch in data.train_dataloader():
                    if skip:
                        skip -= 1
                        continue
                    if step >= self.max_steps:
                        break
                    generator = torch.Generator(device).manual_seed(step_seed(self.seed, step))
                    aux = self.trainer_obj.train_step(state, batch, generator)
                    step = state.step
                    if step % self.log_every == 0 and main:
                        loss = float(aux["loss"] if "loss" in aux else aux["total_loss"])
                        rate = (step - t0_step) / max(time.perf_counter() - t0, 1e-9)
                        print(f"step {step}: loss={loss:.4f} ({rate:.2f} it/s)")
                        if self.metrics_writer is not None:
                            self.metrics_writer.write(
                                step, {"train/loss": loss, "train/it_per_sec": rate})
                    if (main and self.image_logger is not None
                            and self.image_logger.should_log(step)):
                        model = self.ldm if self.ldm is not None else self.trainer_obj.model
                        with self._eval_scope():
                            self.image_logger(model, batch, step,
                                              self._generator(step, LOG_STREAM))
                    if self._melk_agreed(signals) or step % self.ckpt_every == 0:
                        save_last(self.ckpt_dir, state, self._meta())
                        self.melk_requested = False
                    if self.val_every and step % self.val_every == 0:
                        self.validate(state, data)
        except BaseException:
            if world_size() == 1:
                save_last(self.ckpt_dir, state, self._meta())
            raise
        finally:
            if previous is not None:
                signal.signal(signal.SIGUSR1, previous)
            if signals is not None:
                torch.distributed.destroy_process_group(signals)
        save_last(self.ckpt_dir, state, self._meta())
        return state

    def validate(self, state, data: DataModuleFromConfig) -> Dict[str, float]:
        """The loss over up to ``VAL_BATCHES`` validation batches with the
        current weights (``val/loss_simple``) and with the EMA shadow swapped
        into every trained weight (``val/loss_simple_ema``), both from the
        same draws; the losses stay on the device and are fetched once. Then
        the monitored save. An LDM's only."""
        loader = data.val_dataloader()
        if loader is None:
            return {}
        batches = []
        for batch in loader:
            if len(batches) == VAL_BATCHES:
                break
            batches.append(batch)
        loss_fn = self.trainer_obj.loss_fn
        streams = [VAL_STREAM + i for i in range(len(batches))]
        with self._eval_scope():
            losses = [loss_fn(b, self._generator(state.step, s))[0]
                      for b, s in zip(batches, streams)]
            if state.ema is not None:
                with ema_scope(state.ema, state.trainables()):
                    losses += [loss_fn(b, self._generator(state.step, s))[0]
                               for b, s in zip(batches, streams)]
        stacked = torch.stack(losses).float()
        if self.data_group is not None:  # each batch's mean over the ranks' rows
            torch.distributed.all_reduce(stacked, group=self.data_group)
            stacked /= world_size(self.data_group)
        fetched = stacked.cpu().numpy()
        n = len(batches)
        metrics = {"val/loss_simple": float(np.mean(fetched[:n]))}
        if state.ema is not None:
            metrics["val/loss_simple_ema"] = float(np.mean(fetched[n:]))
        if is_main_process():
            print(f"validation @ step {state.step}: {metrics}", flush=True)
            if self.metrics_writer is not None:
                self.metrics_writer.write(state.step, metrics)
        save_monitored(self.ckpt_dir, state, metrics, self.monitor, self.monitored,
                       self._meta())
        return metrics
