"""VAE-GAN training of the KL first stage (port of the KL half of
``sd_tpu/training/vae_gan.py``: ``hinge_d_loss``, ``vanilla_d_loss``,
``adopt_weight``, ``BatchResizeWrapper`` and ``VAEGANTrainer``).

The reference's ``LPIPSWithDiscriminator`` as two steps with two
optimizers, as ``sd_tpu`` has them:

- ``generator_step``: reconstruction (a posterior sample) → the L1 + LPIPS
  reconstruction loss, the NLL under a learned scalar log-variance
  (``logvar``), the KL to N(0, I), and the generator loss −mean(D(rec)) with
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

Precision. On the card the autoencoder and the discriminator keep fp32
master weights and Adam moments and run under bf16 autocast, so that the
mid-blocks' attention (d = 512) goes to K1 and, in the backward, K3; the
frozen LPIPS runs in bf16 under the same autocast; BatchNorm is fp32. On
the CPU everything is fp32 on the kernels' plain versions.

Training a VQ first stage (``VQLPIPSWithDiscriminator``,
``measure_perplexity``) is ROADMAP.md's "Modules to port" item 5; the
training CLI refuses it, naming that item.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sd_tpu_torch.models.vae import AutoencoderKL
from sd_tpu_torch.training.discriminator import NLayerDiscriminator, weights_init
from sd_tpu_torch.training.lpips import LPIPS

__all__ = ["hinge_d_loss", "vanilla_d_loss", "adopt_weight", "BatchResizeWrapper",
           "VAEGANState", "VAEGANTrainer"]

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


def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax ** 2, ax ** 3
    return ((1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1)
            + (-0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2) * ((ax > 1) & (ax <= 2)))


def _resize_weights(in_len: int, out_len: int, scale: float):
    kernel_width = 4.0
    if scale < 1:  # antialias: widen the kernel
        kernel_width /= scale
    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    idx = left[:, None] + np.arange(p)[None, :] - 1
    dist = u[:, None] - idx - 1
    w = scale * _cubic(dist * scale) if scale < 1 else _cubic(dist)
    w = w / np.sum(w, axis=1, keepdims=True)
    idx = np.clip(idx, 0, in_len - 1).astype(np.int64)
    keep = ~np.all(w == 0, axis=0)  # prune zero columns
    return w[:, keep], idx[:, keep]


def imresize(img: np.ndarray, scale: float) -> np.ndarray:
    """MATLAB's bicubic resize with antialiasing, HWC float (a copy of
    ``sd_tpu.data.degradation.imresize``)."""
    img = np.asarray(img, np.float64)
    h, w, _ = img.shape
    oh, ow = int(np.ceil(h * scale)), int(np.ceil(w * scale))
    wh, ih = _resize_weights(h, oh, scale)
    out = np.einsum("oi,oiwc->owc", wh, img[ih])
    ww, iw = _resize_weights(w, ow, scale)
    return np.einsum("oi,hoic->hoc", ww, out[:, iw]).astype(np.float32)


@dataclasses.dataclass
class VAEGANState:
    """The autoencoder and the discriminator (with its BatchNorm running
    statistics), their Adam optimizers, the NLL's log-variance and the step."""

    ae: AutoencoderKL
    ae_opt: torch.optim.Optimizer
    disc: NLayerDiscriminator
    disc_opt: torch.optim.Optimizer
    logvar: torch.Tensor
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "ae": self.ae.state_dict(),
                "ae_opt": self.ae_opt.state_dict(), "disc": self.disc.state_dict(),
                "disc_opt": self.disc_opt.state_dict(), "logvar": self.logvar.detach()}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        self.step = int(sd["step"])
        self.ae.load_state_dict(sd["ae"])
        self.ae_opt.load_state_dict(sd["ae_opt"])
        self.disc.load_state_dict(sd["disc"])
        self.disc_opt.load_state_dict(sd["disc_opt"])
        with torch.no_grad():
            self.logvar.copy_(sd["logvar"])


@dataclasses.dataclass
class VAEGANTrainer:
    """The two-optimizer KL first-stage trainer. The batch is ``sd_tpu``'s
    contract: ``"image"`` NHWC float in [-1, 1], numpy or a tensor."""

    model: AutoencoderKL
    lpips: LPIPS
    disc_start: int = 0
    kl_weight: float = 1.0
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
        self.d_loss_fn = hinge_d_loss if self.disc_loss == "hinge" else vanilla_d_loss

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
        autoencoder's device, both Adam optimizers and the log-variance; the
        autoencoder trains, LPIPS stays frozen in eval."""
        device = self.device
        disc = NLayerDiscriminator(self.disc_in_channels, n_layers=self.disc_num_layers)
        disc = disc.to(device)
        weights_init(disc, torch.Generator(device).manual_seed(seed))
        self.model.train().requires_grad_(True)
        self.lpips.eval().requires_grad_(False)
        disc.train()
        adam = lambda params: torch.optim.Adam(params, lr=self.learning_rate, betas=ADAM_BETAS)
        logvar = torch.tensor(float(self.logvar_init), device=device, requires_grad=True)
        return VAEGANState(ae=self.model, ae_opt=adam(self.model.parameters()), disc=disc,
                           disc_opt=adam(disc.parameters()), logvar=logvar)

    def _images(self, batch: Mapping[str, Any]) -> torch.Tensor:
        return torch.as_tensor(batch["image"], device=self.device).float().permute(0, 3, 1, 2)

    def _rec_nll(self, x: torch.Tensor, rec: torch.Tensor, logvar: torch.Tensor):
        rec = rec.float()
        rec_loss = (x - rec).abs() if self.pixel_loss == "l1" else (x - rec).square()
        rec_loss = self.pixelloss_weight * rec_loss
        if self.perceptual_weight > 0:
            rec_loss = rec_loss + self.perceptual_weight * self.lpips(x, rec).float()
        nll = torch.sum(rec_loss / torch.exp(logvar) + logvar) / x.shape[0]
        return nll, rec_loss

    def generator_step(self, state: VAEGANState, batch: Mapping[str, Any],
                       noise: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One Adam step of the autoencoder and one descent step of
        ``logvar``; ``noise`` is the posterior sample's standard normal draw."""
        x = self._images(batch)
        ae, disc = state.ae, state.disc
        disc.requires_grad_(False)
        state.ae_opt.zero_grad(set_to_none=True)
        state.logvar.grad = None
        with self.autocast():
            rec, posterior = ae(x, noise=noise)
            nll, rec_loss = self._rec_nll(x, rec, state.logvar)
            g_loss = -disc(rec, stats="batch").float().mean()
        kl = torch.sum(posterior.kl()) / x.shape[0]
        if self.disc_factor > 0.0:
            last = ae.get_last_layer()
            g_nll = torch.autograd.grad(nll, last, retain_graph=True)[0]
            g_g = torch.autograd.grad(g_loss, last, retain_graph=True)[0]
            d_weight = torch.norm(g_nll.float()) / (torch.norm(g_g.float()) + 1e-4)
            d_weight = (d_weight.clamp(0.0, 1e4) * self.disc_weight).detach()
        else:
            d_weight = torch.zeros((), device=x.device)
        disc_factor = adopt_weight(self.disc_factor, state.step, self.disc_start)
        loss = nll + self.kl_weight * kl + d_weight * disc_factor * g_loss
        loss.backward()
        state.ae_opt.step()
        with torch.no_grad():
            state.logvar -= self.learning_rate * state.logvar.grad
        disc.requires_grad_(True)
        return {"total_loss": loss.detach(), "nll_loss": nll.detach(), "g_loss": g_loss.detach(),
                "rec_loss": rec_loss.detach().mean(), "d_weight": d_weight,
                "disc_factor": torch.tensor(float(disc_factor)),
                "logvar": state.logvar.detach().clone(), "kl_loss": kl.detach()}

    def discriminator_step(self, state: VAEGANState, batch: Mapping[str, Any],
                           noise: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One Adam step of the discriminator against a reconstruction from
        the autoencoder as it now is (posterior noise ``noise``)."""
        x = self._images(batch)
        with torch.no_grad(), self.autocast():
            rec = state.ae(x, noise=noise)[0].float()
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
        """The latent shape of ``batch``'s posterior, NCHW."""
        b, h, w, _ = np.shape(batch["image"])
        f = 2 ** (len(self.model.decoder.up) - 1)
        return (b, self.model.post_quant_conv.in_channels, h // f, w // f)

    def train_step(self, state: VAEGANState, batch: Mapping[str, Any],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The generator step, then the discriminator step, each with its own
        posterior noise drawn from ``generator``; then the step count."""
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
