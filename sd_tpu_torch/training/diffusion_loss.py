"""The diffusion loss and the LDM train step (port of
``sd_tpu/training/diffusion_loss.py``).

- ``p_losses``: q_sample at the given t, eps/x0 target, l2 or l1, the
  per-timestep logvar weighting and the ELBO term through ``lvlb_weights``;
- ``LDMTrainer``: the frozen first stage and text encoder, ``loss_fn``
  (encode, draw t and noise, loss) and ``train_step`` (gradient accumulation
  over microbatches, AdamW with its LR schedule, EMA);
- ``create_train_state``: AdamW with optax.adamw's defaults (betas 0.9 and
  0.999, eps 1e-8, weight decay 1e-4, not PyTorch's 0.01).

Precision. On the card the UNet keeps fp32 master weights and fp32 AdamW
moments, its forward and backward run under ``torch.autocast`` in bf16 (the
GroupNorm/LayerNorm/softmax islands stay fp32 inside the modules), and the
frozen VAE and CLIP run in bf16 under ``no_grad``. On the CPU everything is
fp32 on the plain versions of the kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from sd_tpu_torch.core.schedules import DiffusionSchedule, q_sample
from sd_tpu_torch.models.ldm import LatentDiffusion
from sd_tpu_torch.training.ema import EmaState, ema_init, ema_update

__all__ = ["p_losses", "make_optimizer", "TrainState", "LDMTrainer", "create_train_state"]

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
    """The trainable UNet with its optimizer, LR schedule, EMA and step."""

    unet: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
    ema: Optional[EmaState] = None
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "unet": self.unet.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict() if self.scheduler else None,
                "ema": self.ema.state_dict() if self.ema else None}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        self.step = int(sd["step"])
        self.unet.load_state_dict(sd["unet"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(sd["scheduler"])
        if self.ema is not None:
            self.ema.load_state_dict(sd["ema"])


@dataclasses.dataclass
class LDMTrainer:
    """Binds an LDM's frozen parts to its train step. The batch is ``sd_tpu``'s
    contract: ``"image"`` NHWC float in [-1, 1] and the token ids under
    ``ldm.cond_stage_key``, as numpy arrays or tensors."""

    ldm: LatentDiffusion
    base_lr: float
    schedule_fn: Optional[Callable[[int], float]] = None
    loss_type: str = "l2"
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0
    use_ema: bool = True
    accumulate_grad_batches: int = 1

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

    def init_state(self) -> TrainState:
        """Freezes the first stage and the text encoder, puts the UNet in
        training mode, and builds AdamW, its schedule and the EMA shadow."""
        for frozen in (self.ldm.first_stage_model, self.ldm.cond_stage_model):
            frozen.eval().requires_grad_(False)
        self.unet.train().requires_grad_(True)
        optimizer, scheduler = make_optimizer(self.unet.parameters(), self.base_lr,
                                              self.schedule_fn)
        ema = ema_init(dict(self.unet.named_parameters())) if self.use_ema else None
        return TrainState(unet=self.unet, optimizer=optimizer, scheduler=scheduler, ema=ema)

    def loss_fn(self, batch: Mapping[str, Any], generator: torch.Generator
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Frozen encode (a posterior sample), then t and noise, all drawn from
        ``generator``; returns ``p_losses``' loss and dict."""
        ldm, device = self.ldm, self.device
        x = torch.as_tensor(batch["image"], device=device).float().permute(0, 3, 1, 2)
        tokens = torch.as_tensor(batch[ldm.cond_stage_key], device=device).long()
        with torch.no_grad(), self.autocast():
            z = ldm.encode_to_latent(x, generator=generator).float()
            cond = ldm.get_learned_conditioning(tokens)
        t = torch.randint(0, ldm.schedule.num_timesteps, (z.shape[0],), generator=generator,
                          device=device)
        noise = torch.randn(z.shape, generator=generator, device=device)
        with self.autocast():
            return p_losses(ldm.apply_model, ldm.schedule, z, cond, t, noise,
                            parameterization=ldm.parameterization, loss_type=self.loss_type,
                            l_simple_weight=self.l_simple_weight,
                            original_elbo_weight=self.original_elbo_weight)

    def train_step(self, state: TrainState, batch: Mapping[str, Any],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One optimizer step. With accumulation the batch's leading axis is
        split into ``accumulate_grad_batches`` microbatches whose gradients
        are averaged; the returned dict is the last microbatch's."""
        accum = self.accumulate_grad_batches
        state.optimizer.zero_grad(set_to_none=True)
        arrays = {k: batch[k] for k in ("image", self.ldm.cond_stage_key)}
        n = len(arrays["image"]) // accum
        for i in range(accum):
            micro = {k: v[i * n:(i + 1) * n] for k, v in arrays.items()}
            loss, aux = self.loss_fn(micro, generator)
            (loss / accum).backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        if state.ema is not None:
            ema_update(state.ema, dict(self.unet.named_parameters()))
        state.step += 1
        return {k: v.detach() for k, v in aux.items()}


def create_train_state(ldm: LatentDiffusion, base_lr: float,
                       schedule_fn: Optional[Callable[[int], float]] = None,
                       **kwargs) -> Tuple[LDMTrainer, TrainState]:
    """Applies the precision policy (on the card: the UNet in fp32, the frozen
    VAE and CLIP in bf16), then builds the trainer and its state: AdamW at
    ``base_lr`` times ``schedule_fn(step)``."""
    if next(ldm.parameters()).device.type == "cuda":
        ldm.model.float()
        ldm.first_stage_model.to(torch.bfloat16)
        ldm.cond_stage_model.to(torch.bfloat16)
    trainer = LDMTrainer(ldm=ldm, base_lr=base_lr, schedule_fn=schedule_fn, **kwargs)
    return trainer, trainer.init_state()
