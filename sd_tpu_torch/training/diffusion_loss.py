"""The diffusion loss and the LDM train step (port of
``sd_tpu/training/diffusion_loss.py``).

- ``p_losses``: q_sample at the given t, eps/x0 target, l2 or l1, the
  per-timestep logvar weighting and the ELBO term through ``lvlb_weights``;
- ``LDMTrainer``: the frozen first stage and the cond stage (frozen, or
  trained with the UNet: ``train_cond_stage``, the reference's
  ``cond_stage_trainable``) under every conditioning key (None, ``concat``,
  ``crossattn``, ``hybrid``, ``adm``: the batch's ``cond_stage_key`` entry
  through the cond stage, then ``apply_model``'s dispatch), ``loss_fn``
  (encode, draw t and noise, loss) and ``train_step`` (gradient
  accumulation over microbatches, AdamW with its LR schedule, EMA over
  every trained weight); ``learn_logvar`` trains
  the per-timestep logvar table (from ``logvar_init``) with the UNet, and
  ``calibrate_scale_by_std`` sets ``scale_factor`` to one over the std of
  a batch's latents (the reference's ``scale_by_std``), refusing a config
  whose ``scale_factor`` is not 1;
- ``create_train_state``: AdamW with optax.adamw's defaults (betas 0.9 and
  0.999, eps 1e-8, weight decay 1e-4, not PyTorch's 0.01).

Data parallelism (``data_group``, under ``torchrun``), as the reference's
Lightning DDP: the trained modules (the UNet, a trained cond stage, a
learned logvar table; not the frozen first stage) are wrapped in one
``DistributedDataParallel``, whose forward is :meth:`LDMTrainer.loss_fn`;
gradients are averaged over the ranks, the non-final micro-batches of an
accumulation run under ``no_sync()``, and with ``zero`` AdamW's moments and
the EMA shadow are partitioned over the ranks (ZeRO-1,
``parallel/mesh.py::zero_state_sharding``; each rank updates the EMA of
what it owns). Each rank holds the rows ``rank::n`` of a global batch (the
loader's shard), and the step's draws (the posterior's noise, t, the
noise) are made for the global micro-batch from the one generator, in the
single-process order, of which the rank takes its rows
(``core/draws.py::RowDraws``): N ranks at batch B step as one process at
batch N·B, and at one rank the draws are the single-process ones.
``sd_tpu``'s ``Trainer.fit`` runs ``train_step`` on one device whatever
the process count, so its multi-process runs train unsynchronised replicas;
the port follows the reference.

Precision. On the card the UNet (and a trained cond stage, and the logvar
table) keeps fp32 master weights and fp32 AdamW moments, its forward and
backward run under ``torch.autocast`` in bf16 (the GroupNorm/LayerNorm/
softmax islands stay fp32 inside the modules), and the frozen first stage
and cond stage run in bf16 under ``no_grad``. On the CPU everything is
fp32 on the plain versions of the kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sd_tpu_torch.core.draws import RowDraws, draw
from sd_tpu_torch.core.schedules import DiffusionSchedule, q_sample
from sd_tpu_torch.models.ldm import LatentDiffusion
from sd_tpu_torch.parallel.mesh import (optimizer_state_dict, rank, world_size,
                                        zero_state_sharding)
from sd_tpu_torch.training.ema import EmaState, ema_init, ema_update
from sd_tpu_torch.utils.checkpoint import COND_STAGE_PREFIX

__all__ = ["p_losses", "cond_to_device", "rows", "make_optimizer", "TrainState", "LDMTrainer",
           "create_train_state"]

# optax.adamw's defaults
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def p_losses(apply_model: Callable, schedule: DiffusionSchedule, x_start: torch.Tensor,
             cond, t: torch.Tensor, noise: torch.Tensor, parameterization: str = "eps",
             loss_type: str = "l2", logvar: Optional[torch.Tensor] = None,
             l_simple_weight: float = 1.0, original_elbo_weight: float = 0.0
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns ``(loss, {"loss", "loss_simple", "loss_vlb"})``."""
    x_noisy = q_sample(schedule, x_start, t, noise)
    model_out = apply_model(x_noisy, t, cond)
    target = noise if parameterization == "eps" else x_start
    if loss_type == "l2":
        err = (model_out.float() - target.float()).square()
    elif loss_type == "l1":
        err = (model_out.float() - target.float()).abs()
    else:
        raise NotImplementedError(loss_type)
    loss_simple = err.mean(dim=tuple(range(1, err.ndim)))  # [B]

    logvar_t = torch.zeros_like(loss_simple) if logvar is None else logvar[t]
    loss = l_simple_weight * (loss_simple / torch.exp(logvar_t) + logvar_t).mean()
    weights = torch.as_tensor(schedule.lvlb_weights, device=loss_simple.device)[t.long()]
    lvlb = (weights * loss_simple).mean()
    loss = loss + original_elbo_weight * lvlb
    return loss, {"loss": loss, "loss_simple": loss_simple.mean(), "loss_vlb": lvlb}


def _map_entry(fn, v):
    """``fn`` on each array of a batch entry: the entry itself, or each
    value of a dict entry or each array of a list of arrays (the hybrid
    key's ``{"c_concat": [...], "c_crossattn": [...]}``)."""
    if isinstance(v, Mapping):
        return {k: _map_entry(fn, x) for k, x in v.items()}
    if isinstance(v, (list, tuple)) and not isinstance(v[0], (int, float, np.generic)):
        return [_map_entry(fn, x) for x in v]
    return fn(v)


def cond_to_device(raw, device):
    """A batch's conditioning entry as the port's modules take it, on
    ``device``: 4-D float arrays (NHWC images) as NCHW float32 tensors,
    other floats as float32, ids as int64."""

    def convert(v):
        c = torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v), device=device)
        if not c.is_floating_point():
            return c.long()
        return c.float().permute(0, 3, 1, 2) if c.ndim == 4 else c.float()

    return _map_entry(convert, raw)


def rows(v, start: int, stop: int):
    """Rows ``start:stop`` of a batch entry."""
    return _map_entry(lambda x: x[start:stop], v)


def make_optimizer(params, base_lr: float, schedule_fn: Optional[Callable[[int], float]] = None
                   ) -> Tuple[torch.optim.AdamW, Optional[torch.optim.lr_scheduler.LambdaLR]]:
    """AdamW with optax.adamw's defaults at ``base_lr``, times
    ``schedule_fn(step)`` through a ``LambdaLR`` when one is given."""
    optimizer = torch.optim.AdamW(params, lr=base_lr, betas=ADAMW_BETAS, eps=ADAMW_EPS,
                                  weight_decay=ADAMW_WEIGHT_DECAY)
    scheduler = (torch.optim.lr_scheduler.LambdaLR(optimizer, schedule_fn)
                 if schedule_fn else None)
    return optimizer, scheduler


@dataclasses.dataclass
class TrainState:
    """The trainable UNet (and the cond stage where it trains, and a learned
    logvar table) with the optimizer, LR schedule, EMA and step."""

    unet: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
    ema: Optional[EmaState] = None
    step: int = 0
    cond_stage: Optional[nn.Module] = None
    logvar: Optional[nn.Parameter] = None

    def trainables(self) -> Dict[str, nn.Parameter]:
        """Every trained weight by its name in the EMA shadow: the UNet's
        own names, the cond stage's under ``COND_STAGE_PREFIX``, and
        ``logvar``."""
        out = dict(self.unet.named_parameters())
        if self.cond_stage is not None:
            out.update({COND_STAGE_PREFIX + n: p for n, p in self.cond_stage.named_parameters()})
        if self.logvar is not None:
            out["logvar"] = self.logvar
        return out

    def state_dict(self) -> Dict[str, Any]:
        """The single-process layout on every rank but the optimizer's, which
        ZeRO-1 consolidates on rank 0 alone (None elsewhere). Under ZeRO-1
        every rank calls it (collectives gather the optimizer's and the
        EMA's shards)."""
        return {"step": self.step, "unet": self.unet.state_dict(),
                "cond_stage": self.cond_stage.state_dict() if self.cond_stage else None,
                "logvar": None if self.logvar is None else self.logvar.detach(),
                "optimizer": optimizer_state_dict(self.optimizer),
                "scheduler": self.scheduler.state_dict() if self.scheduler else None,
                "ema": self.ema.state_dict() if self.ema else None}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        self.step = int(sd["step"])
        self.unet.load_state_dict(sd["unet"])
        if self.cond_stage is not None:
            self.cond_stage.load_state_dict(sd["cond_stage"])
        if self.logvar is not None:
            with torch.no_grad():
                self.logvar.copy_(sd["logvar"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(sd["scheduler"])
        if self.ema is not None:
            self.ema.load_state_dict(sd["ema"])


@dataclasses.dataclass
class LDMTrainer:
    """Binds an LDM's frozen parts to its train step. The batch is ``sd_tpu``'s
    contract: ``"image"`` NHWC float in [-1, 1] and the cond stage's input
    (token ids, class ids) under ``ldm.cond_stage_key``, as numpy arrays or
    tensors."""

    ldm: LatentDiffusion
    base_lr: float
    schedule_fn: Optional[Callable[[int], float]] = None
    loss_type: str = "l2"
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    use_ema: bool = True
    accumulate_grad_batches: int = 1
    train_cond_stage: bool = False
    learn_logvar: bool = False
    logvar_init: float = 0.0
    scale_by_std: bool = False
    # data parallelism: the process group whose ranks split each batch (the
    # whole job: torch.distributed.group.WORLD), None in one process; with
    # zero, ZeRO-1 over it
    data_group: Any = None
    zero: bool = False
    # the learned logvar table (learn_logvar), made by init_state
    logvar: Optional[nn.Parameter] = dataclasses.field(default=None, init=False)
    # the DistributedDataParallel over the trained modules, made by init_state
    ddp: Optional[nn.Module] = dataclasses.field(default=None, init=False)

    @property
    def unet(self) -> nn.Module:
        return self.ldm.model.diffusion_model

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def autocast(self):
        """bf16 autocast on the card; nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.autocast("cuda", dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def trained_modules(self) -> Tuple[nn.Module, ...]:
        """The modules the optimizer trains: the UNet, and the cond stage
        with ``train_cond_stage``."""
        return (self.unet,) + ((self.ldm.cond_stage_model,) if self.train_cond_stage else ())

    def init_state(self) -> TrainState:
        """Freezes the first stage (and the cond stage unless it trains),
        puts the trained modules in training mode, and builds AdamW, its
        schedule and the EMA shadow over every trained weight."""
        frozen = [self.ldm.first_stage_model]
        if not self.train_cond_stage and self.ldm.cond_stage_model is not None:
            frozen.append(self.ldm.cond_stage_model)
        for module in frozen:
            module.eval().requires_grad_(False)
        for module in self.trained_modules():
            module.train().requires_grad_(True)
        if self.learn_logvar:
            self.logvar = nn.Parameter(torch.full((self.ldm.schedule.num_timesteps,),
                                                  float(self.logvar_init), device=self.device))
        state = TrainState(unet=self.unet, optimizer=None,
                           cond_stage=self.ldm.cond_stage_model if self.train_cond_stage else None,
                           logvar=self.logvar)
        params = state.trainables()
        state.optimizer, state.scheduler = make_optimizer(list(params.values()), self.base_lr,
                                                          self.schedule_fn)
        state.ema = ema_init(params) if self.use_ema else None
        if self.data_group is not None:
            from torch.nn.parallel import DistributedDataParallel

            # rank 0's weights go to every rank as DDP starts
            self.ddp = DistributedDataParallel(
                _TrainedModules(self), device_ids=[self.device] if self.device.type == "cuda"
                else None, process_group=self.data_group, gradient_as_bucket_view=True)
            if self.zero:
                zero_state_sharding(state, self.data_group)
        elif self.zero:
            raise ValueError("zero needs a data_group")
        return state

    def _draws(self, generator: Optional[torch.Generator]):
        """``generator``, or under data parallelism this rank's rows of its
        draws for the global micro-batch (the loader's rows ``rank::n``)."""
        n = world_size(self.data_group) if self.data_group is not None else 1
        if generator is None or n == 1:
            return generator
        return RowDraws(generator, rank(self.data_group), n, strided=True)

    def _cond_input(self, batch: Mapping[str, Any]):
        """The cond stage's input: the batch's ``cond_stage_key`` entry on
        the device (NHWC images as NCHW, ids as int64; a dict or list entry
        by entry), or None for an unconditional model or a batch without
        it, as ``sd_tpu`` passes it."""
        raw = batch.get(self.ldm.cond_stage_key)
        if raw is None or self.ldm.cond_stage_model is None:
            return None
        return cond_to_device(raw, self.device)

    def _images(self, batch: Mapping[str, Any]) -> torch.Tensor:
        return torch.as_tensor(batch["image"], device=self.device).float().permute(0, 3, 1, 2)

    @torch.no_grad()
    def calibrate_scale_by_std(self, batch: Mapping[str, Any],
                               generator: Optional[torch.Generator] = None,
                               noise: Optional[torch.Tensor] = None) -> float:
        """Sets ``ldm.scale_factor`` to one over the (unbiased) std of
        ``batch``'s latents, encoded at scale 1 as a posterior sample from
        ``generator`` (or with ``noise``); returns it. Refuses a config that
        set its own ``scale_factor``. Under data parallelism the std is the
        global batch's (the ranks' sums, all-reduced in float64)."""
        if float(self.ldm.scale_factor) != 1.0:
            raise ValueError("rather not use custom rescaling and std-rescaling simultaneously")
        print("### USING STD-RESCALING ###")
        with self.autocast():
            encoding = self.ldm.encode_first_stage(self._images(batch))
        z = encoding if torch.is_tensor(encoding) else encoding.sample(self._draws(generator),
                                                                        noise)
        if self.data_group is None:
            std = float(z.float().flatten().std())
        else:
            zd = z.double().flatten()
            sums = torch.stack([zd.new_tensor(zd.numel()), zd.sum(), zd.square().sum()])
            torch.distributed.all_reduce(sums, group=self.data_group)
            count, total, squares = sums.tolist()
            std = ((squares - total * total / count) / (count - 1)) ** 0.5
        scale = 1.0 / std
        self.ldm.scale_factor = scale
        print(f"setting self.scale_factor to {scale}")
        print("### USING STD-RESCALING ###")
        return scale

    def _logvar(self) -> Optional[torch.Tensor]:
        if self.learn_logvar:
            return self.logvar
        if self.logvar_init != 0.0:  # a fixed table
            return torch.full((self.ldm.schedule.num_timesteps,), float(self.logvar_init),
                              device=self.device)
        return None

    def latents_and_cond(self, batch: Mapping[str, Any],
                         generator: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, Any]:
        """The frozen first stage's latents (a posterior sample drawn from
        ``generator``, the mode without one) and the conditioning (with a
        gradient where the cond stage trains): the cond stage's output for
        the batch's ``cond_stage_key`` entry (the entry itself through a
        ``torch.nn.Identity`` cond stage, as ``bsr_sr``'s ``LR_image``), or
        None for an unconditional model."""
        x = self._images(batch)
        c = self._cond_input(batch)
        with torch.no_grad(), self.autocast():
            z = self.ldm.encode_to_latent(x, generator=generator).float()
        if c is None:
            return z, None
        with torch.set_grad_enabled(self.train_cond_stage and torch.is_grad_enabled()), \
                self.autocast():
            cond = self.ldm.get_learned_conditioning(c)
        return z, cond

    def loss_at(self, z: torch.Tensor, cond, t: torch.Tensor,
                noise: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``p_losses`` at the given t and noise under the trainer's autocast."""
        ldm = self.ldm
        with self.autocast():
            return p_losses(ldm.apply_model, ldm.schedule, z, cond, t, noise,
                            parameterization=ldm.parameterization, loss_type=self.loss_type,
                            logvar=self._logvar(), l_simple_weight=self.l_simple_weight,
                            original_elbo_weight=self.original_elbo_weight)

    def loss_fn(self, batch: Mapping[str, Any], generator: torch.Generator
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Latents and conditioning, then t and noise, all drawn from
        ``generator`` (this rank's rows of the global micro-batch's draws
        under data parallelism); returns ``p_losses``' loss and dict."""
        draws = self._draws(generator)
        z, cond = self.latents_and_cond(batch, draws)
        t = draw(torch.randint, (z.shape[0],), draws, self.device, 0,
                 self.ldm.schedule.num_timesteps)
        noise = draw(torch.randn, z.shape, draws, self.device)
        return self.loss_at(z, cond, t, noise)

    def train_step(self, state: TrainState, batch: Mapping[str, Any],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One optimizer step. With accumulation the batch's leading axis is
        split into ``accumulate_grad_batches`` microbatches whose gradients
        are averaged; the returned dict is the last microbatch's."""
        if self.ldm.int8_mode:
            raise RuntimeError(
                f"the int8 serving mode {sorted(self.ldm.int8_mode.buckets)} is set on the "
                f"model, but it is inference-only: round() has zero gradient a.e., so training "
                f"would silently learn nothing through quantized sites. Build the model with "
                f"int8='off' to train.")
        accum = self.accumulate_grad_batches
        state.optimizer.zero_grad(set_to_none=True)
        arrays = {k: batch[k] for k in ("image", self.ldm.cond_stage_key) if k in batch}
        n = len(arrays["image"]) // accum
        loss_fn = self.loss_fn if self.ddp is None else self.ddp
        for i in range(accum):
            micro = {k: rows(v, i * n, (i + 1) * n) for k, v in arrays.items()}
            # DDP all-reduces the gradients after the last micro-batch only
            sync = self.ddp is None or i == accum - 1
            with contextlib.nullcontext() if sync else self.ddp.no_sync():
                loss, aux = loss_fn(micro, generator)
                (loss / accum).backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        if state.ema is not None:
            ema_update(state.ema, state.trainables())
        state.step += 1
        return {k: v.detach() for k, v in aux.items()}


class _TrainedModules(nn.Module):
    """The trained modules of an :class:`LDMTrainer` as one module for
    ``DistributedDataParallel``; its forward is the trainer's ``loss_fn``."""

    def __init__(self, trainer: LDMTrainer):
        super().__init__()
        self.unet = trainer.unet
        if trainer.train_cond_stage:
            self.cond_stage = trainer.ldm.cond_stage_model
        if trainer.logvar is not None:
            self.logvar = trainer.logvar
        self._loss_fn = trainer.loss_fn

    def forward(self, batch: Mapping[str, Any], generator: torch.Generator):
        return self._loss_fn(batch, generator)


def create_train_state(ldm: LatentDiffusion, base_lr: float,
                       schedule_fn: Optional[Callable[[int], float]] = None,
                       **kwargs) -> Tuple[LDMTrainer, TrainState]:
    """Applies the precision policy (on the card: the UNet and a trained cond
    stage in fp32, the frozen stages in bf16), then builds the trainer and
    its state: AdamW at ``base_lr`` times ``schedule_fn(step)``."""
    if next(ldm.parameters()).device.type == "cuda":
        ldm.model.float()
        ldm.first_stage_model.to(torch.bfloat16)
        trained = kwargs.get("train_cond_stage", False)
        if ldm.cond_stage_model is not None:
            ldm.cond_stage_model.to(torch.float32 if trained else torch.bfloat16)
    trainer = LDMTrainer(ldm=ldm, base_lr=base_lr, schedule_fn=schedule_fn, **kwargs)
    return trainer, trainer.init_state()
