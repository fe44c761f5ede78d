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

Data parallelism (``data_group``, under ``torchrun``), as the reference's
Lightning DDP runs ``configs/autoencoder/*.yaml``: the autoencoder (with,
for a KL model, ``logvar``, so that its gradient is averaged too and every
rank keeps the same ``logvar``) under one ``DistributedDataParallel`` and
the discriminator under another; with ``zero`` both Adam optimizers are
partitioned over the ranks (ZeRO-1, ``parallel/mesh.py::zero_optimizer``).
Each rank holds the rows ``rank::n`` of a global batch (the loader's
shard), and the KL posterior's noise is drawn for the global batch, of
which the rank takes those rows (``core/draws.py::RowDraws``). Three things
stay local to a rank, as under the reference's DDP, so N ranks at batch B
are NOT one process at batch N·B:

- the adaptive weight: its two ``torch.autograd.grad`` calls fire none of
  DDP's hooks, so a rank's ``d_weight`` comes from its own rows;
- BatchNorm's batch statistics in the discriminator (no SyncBatchNorm);
- the discriminator's running statistics: DDP broadcasts rank 0's before
  each forward (``broadcast_buffers``), so rank 0's are the ones that hold
  and the ones a checkpoint keeps.

``shards`` = N is that run written out in one process, the reference the
tests and the dry run hold DDP against: each batch splits into the rows
``s::N``, and each shard takes a rank's step (its own d_weight and batch
statistics, shard 0 alone moving the running statistics) with the gradient
of its loss over N summed into one optimizer step. At N = 1 it is the plain
step. The logs are shard 0's (a rank's: rank 0's rows), as Lightning logs
them without ``sync_dist``: the VQ model's perplexity and cluster usage too.

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
from torch import nn

from sd_tpu_torch.core.draws import RowDraws, draw
from sd_tpu_torch.data.degradation import imresize
from sd_tpu_torch.models.vae import AutoencoderKL, VQModel
from sd_tpu_torch.parallel.mesh import optimizer_state_dict, rank, world_size, zero_optimizer
from sd_tpu_torch.training.discriminator import NLayerDiscriminator, weights_init
from sd_tpu_torch.training.lpips import LPIPS

__all__ = ["hinge_d_loss", "vanilla_d_loss", "adopt_weight", "BatchResizeWrapper",
           "measure_perplexity", "latent_shape", "VAEGANState", "VAEGANTrainer", "build_vae_gan",
           "lpips_from_seed"]

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
    batches advance the count. Under data parallelism every rank draws the
    same sizes: each rank's wrapper starts from the same ``seed`` and draws
    once per train batch, and every rank's loader yields the same number of
    batches (``data/base.py``)."""

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


def latent_shape(model: Union[AutoencoderKL, VQModel], image_shape) -> Tuple[int, ...]:
    """The NCHW latent shape of NHWC images of ``image_shape``: the
    posterior's (or the VQ latent's)."""
    b, h, w, _ = image_shape
    f = 2 ** (len(model.decoder.up) - 1)
    return (b, model.post_quant_conv.in_channels, h // f, w // f)


@dataclasses.dataclass
class VAEGANState:
    """The autoencoder and the discriminator (with its BatchNorm running
    statistics), their Adam optimizers, the KL loss's log-variance (None for
    a VQ model) and the step. Under ZeRO-1 ``state_dict`` gathers both
    optimizers' shards onto rank 0 (every rank calls it; the others get
    None for them), so a checkpoint has the single-process layout."""

    ae: Union[AutoencoderKL, VQModel]
    ae_opt: torch.optim.Optimizer
    disc: NLayerDiscriminator
    disc_opt: torch.optim.Optimizer
    logvar: Optional[torch.Tensor]
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "ae": self.ae.state_dict(),
                "ae_opt": optimizer_state_dict(self.ae_opt), "disc": self.disc.state_dict(),
                "disc_opt": optimizer_state_dict(self.disc_opt),
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
    # data parallelism (module docstring): the process group whose ranks split
    # each batch (torch.distributed.group.WORLD under torchrun), None in one
    # process; with zero, ZeRO-1 over both optimizers
    data_group: Any = None
    zero: bool = False
    # the one-process reference of ``shards`` ranks (module docstring)
    shards: int = 1
    # the DistributedDataParallel wrappers, made by init_state: the
    # autoencoder with logvar, and the discriminator
    ae_ddp: Optional[nn.Module] = dataclasses.field(default=None, init=False)
    disc_ddp: Optional[nn.Module] = dataclasses.field(default=None, init=False)

    def __post_init__(self):
        if self.disc_loss not in ("hinge", "vanilla"):
            raise ValueError(f"disc_loss {self.disc_loss!r}: hinge or vanilla")
        if self.pixel_loss not in ("l1", "l2"):
            raise ValueError(f"pixel_loss {self.pixel_loss!r}: l1 or l2")
        if self.shards < 1 or (self.shards > 1 and self.data_group is not None):
            raise ValueError(f"shards {self.shards}: at least 1, and 1 under a data_group (the "
                             f"shards stand for the group's ranks in one process)")
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

    def trained_modules(self) -> Tuple[nn.Module, ...]:
        """The modules the image logger puts in ``eval()``."""
        return (self.model,)

    def init_state(self, seed: int = 0) -> VAEGANState:
        """The discriminator (taming's init, drawn from ``seed``) on the
        autoencoder's device, both Adam optimizers and, for a KL model, the
        log-variance; the autoencoder trains, LPIPS stays frozen in eval.
        Under a data group, the two DDP wrappers (rank 0's weights go to
        every rank as they start) and, with ``zero``, ZeRO-1."""
        device = self.device
        disc = NLayerDiscriminator(self.disc_in_channels, n_layers=self.disc_num_layers)
        disc = disc.to(device)
        weights_init(disc, torch.Generator(device).manual_seed(seed))
        self.model.train().requires_grad_(True)
        self.lpips.eval().requires_grad_(False)
        disc.train()
        adam = lambda params: torch.optim.Adam(params, lr=self.learning_rate, betas=ADAM_BETAS)
        logvar = None if self.is_vq else nn.Parameter(torch.tensor(float(self.logvar_init),
                                                                    device=device))
        state = VAEGANState(ae=self.model, ae_opt=adam(self.model.parameters()), disc=disc,
                            disc_opt=adam(disc.parameters()), logvar=logvar)
        if self.data_group is not None:
            from torch.nn.parallel import DistributedDataParallel

            kw = dict(device_ids=[device] if device.type == "cuda" else None,
                      process_group=self.data_group, gradient_as_bucket_view=True)
            self.ae_ddp = DistributedDataParallel(_Autoencoder(self, state), **kw)
            # broadcast_buffers (DDP's default): rank 0's running statistics
            # reach every rank before each of the discriminator's forwards
            self.disc_ddp = DistributedDataParallel(disc, **kw)
            if self.zero:
                state.ae_opt = zero_optimizer(state.ae_opt, self.data_group)
                state.disc_opt = zero_optimizer(state.disc_opt, self.data_group)
        elif self.zero:
            raise ValueError("zero needs a data_group")
        return state

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
        # of these rows alone: under DDP a rank's, and rank 0's are logged,
        # as Lightning logs them (no sync_dist)
        perplexity, usage = measure_perplexity(idx, self.model.quantize.n_embed)
        return rec_loss.mean(), qloss, rec_loss, rec, {
            "quant_loss": qloss.detach(), "p_loss": p_loss.detach().mean(),
            "perplexity": perplexity, "cluster_usage": usage}

    def _shards(self, *tensors):
        """Each shard's rows ``s::N`` of the tensors (None stays None): the
        tensors themselves at N = 1."""
        n = self.shards
        for s in range(n):
            yield s, [t if n == 1 or t is None else t[s::n] for t in tensors]

    def _generator_loss(self, state: VAEGANState, x: torch.Tensor,
                        noise: Optional[torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One rank's (or shard's) generator loss and its logs: the
        reconstruction terms (through the autoencoder's DDP where there is
        one), the GAN term through the bare discriminator on the rows' batch
        statistics (its DDP would ready itself for a backward that never
        reaches it), and the adaptive weight of these rows alone."""
        with self.autocast():
            if self.ae_ddp is None:
                terms = self._reconstruction_terms(state.ae, x, noise, state.logvar)
            else:
                terms = self.ae_ddp(x, noise)
            nll, reg, rec_loss, rec, logs = terms
            g_loss = -state.disc(rec, stats="batch").float().mean()
        if self.disc_factor > 0.0:
            # autograd.grad fires none of DDP's hooks: d_weight is these rows'
            last = state.ae.get_last_layer()
            g_nll = torch.autograd.grad(nll, last, retain_graph=True)[0]
            g_g = torch.autograd.grad(g_loss, last, retain_graph=True)[0]
            d_weight = torch.norm(g_nll.float()) / (torch.norm(g_g.float()) + 1e-4)
            d_weight = (d_weight.clamp(0.0, 1e4) * self.disc_weight).detach()
        else:
            d_weight = torch.zeros((), device=x.device)
        disc_factor = adopt_weight(self.disc_factor, state.step, self.disc_start)
        reg_weight = self.codebook_weight if self.is_vq else self.kl_weight
        loss = nll + reg_weight * reg + d_weight * disc_factor * g_loss
        return loss, {"total_loss": loss.detach(), "nll_loss": nll.detach(),
                      "g_loss": g_loss.detach(), "rec_loss": rec_loss.detach().mean(),
                      "d_weight": d_weight, "disc_factor": torch.tensor(float(disc_factor)),
                      **logs}

    def generator_step(self, state: VAEGANState, batch: Mapping[str, Any],
                       noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One Adam step of the autoencoder (and, KL, one descent step of
        ``logvar``); ``noise`` is the KL posterior sample's standard normal
        draw (None for a VQ model). With ``shards``, the shards' gradients
        over N; the logs are shard 0's."""
        x = self._images(batch)
        state.disc.requires_grad_(False)
        state.ae_opt.zero_grad(set_to_none=True)
        if state.logvar is not None:
            state.logvar.grad = None
        for s, (xs, ns) in self._shards(x, noise):
            loss, log = self._generator_loss(state, xs, ns)
            (loss if self.shards == 1 else loss / self.shards).backward()
            if s == 0:
                logs = log
        state.ae_opt.step()
        if state.logvar is not None:
            with torch.no_grad():
                state.logvar -= self.learning_rate * state.logvar.grad
            logs["logvar"] = state.logvar.detach().clone()
        state.disc.requires_grad_(True)
        return logs

    def discriminator_step(self, state: VAEGANState, batch: Mapping[str, Any],
                           noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One Adam step of the discriminator against a reconstruction from
        the autoencoder as it now is (KL posterior noise ``noise``), through
        the discriminator's DDP where there is one. With ``shards``, each
        shard's loss over N, and shard 0 alone moves the running statistics
        (rank 0's hold under DDP); the logs are shard 0's."""
        x = self._images(batch)
        disc_factor = adopt_weight(self.disc_factor, state.step, self.disc_start)
        disc = state.disc if self.disc_ddp is None else self.disc_ddp
        state.disc_opt.zero_grad(set_to_none=True)
        for s, (xs, ns) in self._shards(x, noise):
            with torch.no_grad(), self.autocast():
                rec = (state.ae(xs) if self.is_vq else state.ae(xs, noise=ns))[0].float()
            # two forwards, then one backward: each parameter's gradient is
            # one sum, reduced once by DDP; the real and the reconstructed
            # images keep their own batch statistics
            stats = "update" if s == 0 else "batch"
            with self.autocast():
                logits_real = disc(xs, stats=stats).float()
                logits_fake = disc(rec, stats=stats).float()
            d_loss = disc_factor * self.d_loss_fn(logits_real, logits_fake)
            (d_loss if self.shards == 1 else d_loss / self.shards).backward()
            if s == 0:
                logs = {"disc_loss": d_loss.detach(), "logits_real": logits_real.detach().mean(),
                        "logits_fake": logits_fake.detach().mean()}
        state.disc_opt.step()
        return logs

    def posterior_shape(self, batch: Mapping[str, Any]) -> Tuple[int, ...]:
        """The latent shape of ``batch``'s posterior (or VQ latent), NCHW."""
        return latent_shape(self.model, np.shape(batch["image"]))

    def _draws(self, generator: torch.Generator):
        """``generator``, or under data parallelism this rank's rows of its
        draws for the global batch (the loader's rows ``rank::n``)."""
        n = world_size(self.data_group) if self.data_group is not None else 1
        if n == 1:
            return generator
        return RowDraws(generator, rank(self.data_group), n, strided=True)

    def train_step(self, state: VAEGANState, batch: Mapping[str, Any],
                   generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The generator step, then the discriminator step, each (KL) with
        its own posterior noise drawn from ``generator`` (for the global
        batch under data parallelism, of which the rank takes its rows); then
        the step count. A VQ model draws nothing."""
        noise_g = noise_d = None
        if not self.is_vq:
            shape, draws = self.posterior_shape(batch), self._draws(generator)
            noise_g = draw(torch.randn, shape, draws, self.device)
            noise_d = draw(torch.randn, shape, draws, self.device)
        log = self.generator_step(state, batch, noise_g)
        log.update(self.discriminator_step(state, batch, noise_d))
        state.step += 1
        return log


class _Autoencoder(nn.Module):
    """The autoencoder and, for a KL model, ``logvar`` as one module for
    ``DistributedDataParallel``; its forward is the trainer's
    reconstruction terms."""

    def __init__(self, trainer: VAEGANTrainer, state: VAEGANState):
        super().__init__()
        self.ae = state.ae
        self.logvar = state.logvar
        self._terms = trainer._reconstruction_terms

    def forward(self, x: torch.Tensor, noise: Optional[torch.Tensor]):
        return self._terms(self.ae, x, noise, self.logvar)


def build_vae_gan(model_cfg: Mapping[str, Any], device, seed: int, learning_rate: float,
                  **kwargs) -> Tuple[VAEGANTrainer, VAEGANState]:
    """A first-stage config node's model with seeded random weights on
    ``device`` (``init_random_`` from ``seed``), LPIPS from ``seed``, the
    trainer with the node's ``lossconfig`` (``kwargs`` on top: the data
    group, ``zero``, ``shards``, or loss keys) and its initial state."""
    from sd_tpu_torch.utils.config import init_random_, instantiate_from_config

    with torch.device("meta"):
        model = instantiate_from_config(dict(model_cfg))
    model.to_empty(device=device)
    init_random_(model, torch.Generator(device=device).manual_seed(seed))
    p = model_cfg["params"]
    loss_kwargs = instantiate_from_config(p.get("lossconfig", {}))
    if not isinstance(loss_kwargs, dict):
        raise ValueError(f"lossconfig {p['lossconfig']['target']}: no training loss (the "
                         f"inference configs' torch.nn.Identity); give LPIPSWithDiscriminator "
                         f"or VQLPIPSWithDiscriminator to train a first stage")
    trainer = VAEGANTrainer(model=model, lpips=lpips_from_seed(seed, device),
                            learning_rate=learning_rate, **{**loss_kwargs, **kwargs})
    return trainer, trainer.init_state(seed=seed)


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
