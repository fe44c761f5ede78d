"""The noisy-latent classifier and classifier guidance (port of
``sd_tpu/training/classifier.py``; the reference's
``NoisyLatentImageClassifier``).

- :func:`compute_top_k`: acc@k of logits against integer labels;
- :class:`NoisyLatentClassifierTrainer`: an ``EncoderUNetModel`` trained on
  latents diffused to a uniformly drawn t (``encode_fn`` maps images to the
  frozen diffusion model's latents; without it the images themselves),
  cross-entropy against the batch's ``label_key``, AdamW (optax.adamw's
  betas 0.9 and 0.999, eps 1e-8; ``weight_decay`` 1e-2, decoupled), logging
  the loss, acc@1, acc@5 and the mean t; :meth:`eval_noise_buckets` gives
  acc@1 at the middle t of each of ``noise_level_buckets`` buckets;
- :func:`classifier_guidance_corrector`: a sampler's ``score_corrector``
  that shifts ε by −s·sqrt(1 − ᾱ_t)·∇ₓ log p(y | x_t), the gradient
  through ``torch.autograd.grad``.

Precision. On the card the classifier keeps fp32 master weights and AdamW
moments and runs under bf16 autocast, so that its attention goes to K1 (and
K3 in the backward where ``sd_tpu``'s rule takes it); the frozen encode runs
in bf16 under ``no_grad``, as ``encode_fn`` gives it. On the CPU everything
is fp32 on the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from sd_tpu_torch.core.schedules import DiffusionSchedule, q_sample
from sd_tpu_torch.models.encoder_unet import EncoderUNetModel

__all__ = ["compute_top_k", "ClassifierState", "NoisyLatentClassifierTrainer",
           "classifier_guidance_corrector"]

ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8


def compute_top_k(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """The share of rows whose label is among the ``k`` largest logits."""
    top = logits.topk(k, dim=-1).indices
    return (top == labels[:, None]).any(dim=1).float().mean()


@dataclasses.dataclass
class ClassifierState:
    model: EncoderUNetModel
    optimizer: torch.optim.Optimizer
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])


@dataclasses.dataclass
class NoisyLatentClassifierTrainer:
    """Trains logits(x_t, t). The batch is ``sd_tpu``'s contract:
    ``"image"`` NHWC float in [-1, 1] and integer labels under
    ``label_key``. ``encode_fn(images NCHW, generator)`` → latents NCHW."""

    model: EncoderUNetModel
    schedule: DiffusionSchedule
    encode_fn: Optional[Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]] = None
    label_key: str = "class_label"
    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    noise_level_buckets: int = 10

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def autocast(self):
        """bf16 autocast on the card; nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.autocast("cuda", dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def init_state(self) -> ClassifierState:
        self.model.train().requires_grad_(True)
        optimizer = torch.optim.AdamW(self.model.parameters(), lr=self.learning_rate,
                                      betas=ADAMW_BETAS, eps=ADAMW_EPS,
                                      weight_decay=self.weight_decay)
        return ClassifierState(model=self.model, optimizer=optimizer)

    def inputs(self, batch: Mapping[str, Any], generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(x, labels)``: the batch's latents (``encode_fn`` without a
        gradient, its draws from ``generator``) or images, NCHW fp32, and
        its labels as int64."""
        x = torch.as_tensor(batch["image"], device=self.device).float().permute(0, 3, 1, 2)
        if self.encode_fn is not None:
            with torch.no_grad():
                x = self.encode_fn(x, generator).float()
        labels = torch.as_tensor(batch[self.label_key], device=self.device).long()
        return x, labels

    def loss_at(self, x: torch.Tensor, labels: torch.Tensor, t: torch.Tensor,
                noise: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The cross-entropy of the logits of ``x`` diffused to ``t`` with
        ``noise``, under the trainer's autocast; returns ``(loss, logs)``."""
        x_noisy = q_sample(self.schedule, x, t, noise)
        with self.autocast():
            logits = self.model(x_noisy, t.float()).float()
        loss = F.cross_entropy(logits, labels)
        return loss, {"loss": loss, "acc@1": compute_top_k(logits, labels, 1),
                      "acc@5": compute_top_k(logits, labels, min(5, logits.shape[-1])),
                      "t_mean": t.float().mean()}

    def loss_fn(self, batch: Mapping[str, Any], generator: torch.Generator
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The inputs, then t and noise, all drawn from ``generator``."""
        x, labels = self.inputs(batch, generator)
        t = torch.randint(0, self.schedule.num_timesteps, (x.shape[0],), generator=generator,
                          device=self.device)
        noise = torch.randn(x.shape, generator=generator, device=self.device)
        return self.loss_at(x, labels, t, noise)

    def train_step(self, state: ClassifierState, batch: Mapping[str, Any],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One AdamW step; returns the step's logs."""
        state.optimizer.zero_grad(set_to_none=True)
        loss, logs = self.loss_fn(batch, generator)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        return {k: v.detach() for k, v in logs.items()}

    @torch.no_grad()
    def eval_noise_buckets(self, state: ClassifierState, batch: Mapping[str, Any],
                           generator: torch.Generator) -> Dict[str, float]:
        """acc@1 at t = (i + 1/2)·T / buckets for each bucket i, each with
        its own noise from ``generator``, the model in eval mode."""
        x, labels = self.inputs(batch, generator)
        total = self.schedule.num_timesteps
        out = {}
        state.model.eval()
        try:
            for i in range(self.noise_level_buckets):
                t_val = int((i + 0.5) * total / self.noise_level_buckets)
                t = torch.full((x.shape[0],), t_val, dtype=torch.long, device=self.device)
                noise = torch.randn(x.shape, generator=generator, device=self.device)
                with self.autocast():
                    logits = state.model(q_sample(self.schedule, x, t, noise), t.float())
                out[f"acc@1_t{t_val}"] = float(compute_top_k(logits.float(), labels, 1))
        finally:
            state.model.train()
        return out


def classifier_guidance_corrector(model: EncoderUNetModel, schedule: DiffusionSchedule,
                                  target_labels: torch.Tensor, scale: float = 1.0) -> Callable:
    """A ``score_corrector(e_t, x, t, cond)`` for the samplers: ``e_t −
    scale · sqrt(1 − ᾱ_t) · ∇ₓ Σ log softmax(model(x, t))[y]``, ADM's
    classifier guidance, with y ``target_labels``."""
    sqrt_1m = torch.as_tensor(schedule.sqrt_one_minus_alphas_cumprod)

    def corrector(e_t: torch.Tensor, x: torch.Tensor, t: torch.Tensor, cond) -> torch.Tensor:
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            logits = model(xx, t.float()).float()
            logp = F.log_softmax(logits, dim=-1)
            picked = logp[torch.arange(xx.shape[0], device=xx.device),
                          target_labels.to(xx.device)].sum()
            grad = torch.autograd.grad(picked, xx)[0]
        s1m = sqrt_1m.to(x.device)[t.long()].reshape((-1,) + (1,) * (x.ndim - 1))
        return e_t - scale * s1m * grad.to(e_t.dtype)

    return corrector
