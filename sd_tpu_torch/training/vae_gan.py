"""VAE-GAN training of the first stages (port of
``sd_tpu/training/vae_gan.py``: ``hinge_d_loss``, ``vanilla_d_loss``,
``adopt_weight``, ``BatchResizeWrapper``, ``measure_perplexity`` and
``VAEGANTrainer`` in KL and VQ mode).

The reference's ``LPIPSWithDiscriminator`` (a KL model) and
``VQLPIPSWithDiscriminator`` (a VQ model) as two steps with two
optimizers, as ``sd_tpu`` has them:

- ``generator_step``: the reconstruction (KL: a posterior sample) → the
  L1 (or L2) + LPIPS reconstruction loss; KL: the NLL under a learned
  scalar log-variance (``logvar``) and the KL to N(0, I); VQ: the mean of
  the reconstruction loss and the codebook loss, with the codes'
  perplexity and usage logged; and the generator loss −mean(D(rec)) with
  the discriminator in training mode on the batch's own statistics (which
  it does not keep). The adaptive weight is the ratio of the gradient norms
  of the NLL and of the generator loss at the decoder's last conv weight,
  two ``torch.autograd.grad`` calls on that one weight, clipped to [0, 1e4],
  times ``disc_weight``, and detached. Adam (betas 0.5, 0.9) on the
  autoencoder; ``logvar`` moves by plain gradient descent at the same LR,
  as ``sd_tpu`` moves it;
- ``discriminator_step``: a second reconstruction without a gradient, the
  hinge (or vanilla) loss on real and reconstructed images through the
  discriminator in training mode, its BatchNorm running statistics moved
  by the real batch, then the reconstructed one; Adam on the discriminator.

Both the generator's GAN term and the discriminator's loss are weighted by
``disc_factor`` from step ``disc_start`` on and by 0 before it.

The VQ loss is the reference's, not ``sd_tpu``'s: ``sd_tpu`` reuses the KL
loss's NLL in VQ mode, ``sum(rec_loss / exp(logvar) + logvar) / B`` with a
trained ``logvar``, which weighs the reconstruction H·W·C times more
against the codebook term than the reference's ``mean(rec_loss)``
(ROADMAP.md, known faults of the reference).

Precision. On the card the autoencoder and the discriminator keep fp32
master weights and Adam moments and run under bf16 autocast, so that the
mid-blocks' attention (d = 512) goes to K1 and, in the backward, K3; the
frozen LPIPS runs in bf16 under the same autocast; BatchNorm is fp32; the
quantizer's distances and its loss are fp32 with autocast and TF32 off.
On the CPU everything is fp32 on the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from sd_tpu_torch.data.degradation import imresize
from sd_tpu_torch.models.vae import AutoencoderKL, VQModel
from sd_tpu_torch.training.discriminator import NLayerDiscriminator, weights_init
from sd_tpu_torch.training.lpips import LPIPS

__all__ = ["hinge_d_loss", "vanilla_d_loss", "adopt_weight", "BatchResizeWrapper",
           "measure_perplexity", "VAEGANState", "VAEGANTrainer"]

# Adam's betas for both optimizers (the reference's configure_optimizers)
ADAM_BETAS = (0.5, 0.9)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """``weight`` from step ``threshold`` on, ``value`` before it."""
    return value if global_step < threshold else weight


class BatchResizeWrapper:
    """Resizes every batch of a data module to a size drawn uniformly from
    the multiples of 16 in ``resize_range`` (the largest for the first five
    train batches, so that running out of memory shows at once), with
    MATLAB's antialiased bicubic (``imresize``) on the host. Only train
    batches advance the count."""

    def __init__(self, data, resize_range, seed: int = 0):
        lo, hi = resize_range
        if lo % 16 or hi % 16 or lo > hi:
            raise ValueError(f"batch_resize_range must be ascending multiples of 16, got "
                             f"{resize_range}")
        self._data = data
        self.resize_range = (int(lo), int(hi))
        self._rng = np.random.default_rng(seed)
        self.global_step = 0

    def _resize_batch(self, batch, advance: bool):
        x = batch.get("image")
        if x is None:
            return batch
        lo, hi = self.resize_range
        new = hi if self.global_step <= 4 else int(self._rng.choice(np.arange(lo, hi + 16, 16)))
        if advance:
            self.global_step += 1
        x = np.asarray(x)
        if new != x.shape[1]:
            batch = dict(batch, image=np.stack([imresize(im, new / x.shape[1]) for im in x]))
        return batch

    def _wrap(self, it, advance: bool):
        return None if it is None else (self._resize_batch(b, advance) for b in it)

    def train_dataloader(self):
        return self._wrap(self._data.train_dataloader(), True)

    def val_dataloader(self):
        return self._wrap(self._data.val_dataloader(), False)

    def __getattr__(self, name):
        return getattr(self._data, name)


def measure_perplexity(indices: torch.Tensor, n_embed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(perplexity, cluster usage)`` of the code indices: exp of the
    entropy of the codes' frequencies, and how many codes were used. The
    frequencies are counts (``bincount``), not a one-hot mean, which would
    take 1 GiB at 8 images of 64x64 codes over 8192 (equal: both are exact
    counts over the same total)."""
    counts = torch.bincount(indices.reshape(-1), minlength=n_embed).float()
    avg = counts / indices.numel()
    perplexity = torch.exp(-torch.sum(avg * torch.log(avg + 1e-10)))
    return perplexity, torch.sum(avg > 0)


@dataclasses.dataclass
class VAEGANState:
    """The autoencoder and the discriminator (with its BatchNorm running
    statistics), their Adam optimizers, the KL loss's log-variance (None for
    a VQ model) and the step."""

    ae: Union[AutoencoderKL, VQModel]
    ae_opt: torch.optim.Optimizer
    disc: NLayerDiscriminator
    disc_opt: torch.optim.Optimizer
    logvar: Optional[torch.Tensor]
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "ae": self.ae.state_dict(),
                "ae_opt": self.ae_opt.state_dict(), "disc": self.disc.state_dict(),
                "disc_opt": self.disc_opt.state_dict(),
                "logvar": None if self.logvar is None else self.logvar.detach()}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        self.step = int(sd["step"])
        self.ae.load_state_dict(sd["ae"])
        self.ae_opt.load_state_dict(sd["ae_opt"])
        self.disc.load_state_dict(sd["disc"])
        self.disc_opt.load_state_dict(sd["disc_opt"])
        if self.logvar is not None:
            with torch.no_grad():
                self.logvar.copy_(sd["logvar"])


@dataclasses.dataclass
class VAEGANTrainer:
    """The two-optimizer first-stage trainer, KL or VQ by the model's type.
    The batch is ``sd_tpu``'s contract: ``"image"`` NHWC float in [-1, 1],
    numpy or a tensor. ``kl_weight`` and ``logvar_init`` are the KL loss's;
    ``codebook_weight`` the VQ loss's."""

    model: Union[AutoencoderKL, VQModel]
    lpips: LPIPS
    disc_start: int = 0
    kl_weight: float = 1.0
    codebook_weight: float = 1.0
    pixelloss_weight: float = 1.0
    perceptual_weight: float = 1.0
    disc_num_layers: int = 3
    disc_in_channels: int = 3
    disc_factor: float = 1.0
    disc_weight: float = 1.0
    disc_loss: str = "hinge"
    pixel_loss: str = "l1"
    learning_rate: float = 4.5e-6
    logvar_init: float = 0.0

    def __post_init__(self):
        if self.disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss {self.disc_loss!r}: hinge or vanilla")
        if self.pixel_loss not in ("l1", "l2"):
            raise ValueError(f"pixel_loss {self.pixel_loss!r}: l1 or l2")
        self.d_loss_fn = hinge_d_loss if self.disc_loss == "hinge" else vanilla_d_loss
        self.is_vq = isinstance(self.model, VQModel)

    @property
    def device(self) -> torch.device:
        return self.model.get_last_layer().device

    def autocast(self):
        """bf16 autocast on the card; nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.autocast("cuda", dtype=torch.bfloat16)
        return contextlib.nullcontext()

    def init_state(self, seed: int = 0) -> VAEGANState:
        """The discriminator (taming's init, drawn from ``seed``) on the
        autoencoder's device, both Adam optimizers and, for a KL model, the
        log-variance; the autoencoder trains, LPIPS stays frozen in eval."""
        device = self.device
        disc = NLayerDiscriminator(self.disc_in_channels, n_layers=self.disc_num_layers)
        disc = disc.to(device)
        weights_init(disc, torch.Generator(device).manual_seed(seed))
        self.model.train().requires_grad_(True)
        self.lpips.eval().requires_grad_(False)
        disc.train()
        adam = lambda params: torch.optim.Adam(params, lr=self.learning_rate, betas=ADAM_BETAS)
        logvar = None if self.is_vq else torch.tensor(float(self.logvar_init), device=device,
                                                      requires_grad=True)
        return VAEGANState(ae=self.model, ae_opt=adam(self.model.parameters()), disc=disc,
                           disc_opt=adam(disc.parameters()), logvar=logvar)

    def _images(self, batch: Mapping[str, Any]) -> torch.Tensor:
        return torch.as_tensor(batch["image"], device=self.device).float().permute(0, 3, 1, 2)

    def _rec_loss(self, x: torch.Tensor, rec: torch.Tensor, pixel_weight: float):
        """``(rec_loss, p_loss)``: the pixel loss per element times
        ``pixel_weight``, plus ``perceptual_weight`` times LPIPS per image;
        and LPIPS per image."""
        rec = rec.float()
        rec_loss = (x - rec).abs() if self.pixel_loss == "l1" else (x - rec).square()
        rec_loss = pixel_weight * rec_loss
        p_loss = torch.zeros((), device=x.device)
        if self.perceptual_weight > 0:
            p_loss = self.lpips(x, rec).float()
            rec_loss = rec_loss + self.perceptual_weight * p_loss
        return rec_loss, p_loss

    def _reconstruction_terms(self, ae, x: torch.Tensor, noise: Optional[torch.Tensor],
                              logvar: Optional[torch.Tensor]):
        """``(nll, regularizer, rec_loss, rec, logs)`` of one reconstruction.
        KL: the NLL under ``logvar``, ``sum(rec_loss / exp(logvar) + logvar)
        / B`` with ``pixelloss_weight`` applied, and the KL of the posterior
        (sampled with ``noise``) to N(0, I), summed per image. VQ, the
        reference's ``VQLPIPSWithDiscriminator``: the mean of ``rec_loss``
        over every element (``pixelloss_weight`` taken and not applied, as
        there), and the codebook loss; the codes' perplexity and usage."""
        if not self.is_vq:
            rec, posterior = ae(x, noise=noise)
            rec_loss, _ = self._rec_loss(x, rec, self.pixelloss_weight)
            nll = torch.sum(rec_loss / torch.exp(logvar) + logvar) / x.shape[0]
            kl = torch.sum(posterior.kl()) / x.shape[0]
            return nll, kl, rec_loss, rec, {"kl_loss": kl.detach()}
        rec, qloss, idx = ae(x)
        rec_loss, p_loss = self._rec_loss(x, rec, 1.0)
        perplexity, usage = measure_perplexity(idx, self.model.quantize.n_embed)
        return rec_loss.mean(), qloss, rec_loss, rec, {
            "quant_loss": qloss.detach(), "p_loss": p_loss.detach().mean(),
            "perplexity": perplexity, "cluster_usage": usage}

    def generator_step(self, state: VAEGANState, batch: Mapping[str, Any],
                       noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One Adam step of the autoencoder (and, KL, one descent step of
        ``logvar``); ``noise`` is the KL posterior sample's standard normal
        draw (None for a VQ model)."""
        x = self._images(batch)
        ae, disc = state.ae, state.disc
        disc.requires_grad_(False)
        state.ae_opt.zero_grad(set_to_none=True)
        if state.logvar is not None:
            state.logvar.grad = None
        with self.autocast():
            nll, reg, rec_loss, rec, logs = self._reconstruction_terms(ae, x, noise, state.logvar)
            g_loss = -disc(rec, stats="batch").float().mean()
        if self.disc_factor > 0.0:
            last = ae.get_last_layer()
            g_nll = torch.autograd.grad(nll, last, retain_graph=True)[0]
            g_g = torch.autograd.grad(g_loss, last, retain_graph=True)[0]
            d_weight = torch.norm(g_nll.float()) / (torch.norm(g_g.float()) + 1e-4)
            d_weight = (d_weight.clamp(0.0, 1e4) * self.disc_weight).detach()
        else:
            d_weight = torch.zeros((), device=x.device)
        disc_factor = adopt_weight(self.disc_factor, state.step, self.disc_start)
        reg_weight = self.codebook_weight if self.is_vq else self.kl_weight
        loss = nll + reg_weight * reg + d_weight * disc_factor * g_loss
        loss.backward()
        state.ae_opt.step()
        if state.logvar is not None:
            with torch.no_grad():
                state.logvar -= self.learning_rate * state.logvar.grad
            logs["logvar"] = state.logvar.detach().clone()
        disc.requires_grad_(True)
        return {"total_loss": loss.detach(), "nll_loss": nll.detach(), "g_loss": g_loss.detach(),
                "rec_loss": rec_loss.detach().mean(), "d_weight": d_weight,
                "disc_factor": torch.tensor(float(disc_factor)), **logs}

    def discriminator_step(self, state: VAEGANState, batch: Mapping[str, Any],
                           noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One Adam step of the discriminator against a reconstruction from
        the autoencoder as it now is (KL posterior noise ``noise``)."""
        x = self._images(batch)
        with torch.no_grad(), self.autocast():
            rec = (state.ae(x) if self.is_vq else state.ae(x, noise=noise))[0].float()
        disc_factor = adopt_weight(self.disc_factor, state.step, self.disc_start)
        state.disc_opt.zero_grad(set_to_none=True)
        with self.autocast():
            logits_real = state.disc(x, stats="update").float()
            logits_fake = state.disc(rec, stats="update").float()
        d_loss = disc_factor * self.d_loss_fn(logits_real, logits_fake)
        d_loss.backward()
        state.disc_opt.step()
        return {"disc_loss": d_loss.detach(), "logits_real": logits_real.detach().mean(),
                "logits_fake": logits_fake.detach().mean()}

    def posterior_shape(self, batch: Mapping[str, Any]) -> Tuple[int, ...]:
        """The latent shape of ``batch``'s posterior (or VQ latent), NCHW."""
        b, h, w, _ = np.shape(batch["image"])
        f = 2 ** (len(self.model.decoder.up) - 1)
        return (b, self.model.post_quant_conv.in_channels, h // f, w // f)

    def train_step(self, state: VAEGANState, batch: Mapping[str, Any],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The generator step, then the discriminator step, each (KL) with
        its own posterior noise drawn from ``generator``; then the step
        count. A VQ model draws nothing."""
        noise_g = noise_d = None
        if not self.is_vq:
            shape = self.posterior_shape(batch)
            noise_g = torch.randn(shape, generator=generator, device=self.device)
            noise_d = torch.randn(shape, generator=generator, device=self.device)
        log = self.generator_step(state, batch, noise_g)
        log.update(self.discriminator_step(state, batch, noise_d))
        state.step += 1
        return log


def lpips_from_seed(seed: int, device) -> LPIPS:
    """LPIPS with seeded random weights (the released ones are not in the
    repository): convs N(0, 1/fan_in), biases 0, and the heads' weights
    |N(0, 1/C)| (non-negative, as the released heads are)."""
    lpips = LPIPS().to(device)
    g = torch.Generator(device).manual_seed(seed)
    with torch.no_grad():
        for name, p in lpips.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=g)
                if name.startswith("lin"):
                    p.abs_()
    return lpips.eval()
