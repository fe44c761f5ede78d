"""The port's KL first-stage (VAE-GAN) training on the CPU against sd_tpu's,
in fp32: VGG16's trunk, LPIPS, the PatchGAN discriminator in training mode,
and VAEGANTrainer's generator and discriminator steps on
configs/sd_tpu/tiny-autoencoder-kl.yaml as the training CLI builds it,
before and after disc_start.

sd_tpu's random parameters go into both packages (sd_tpu_torch.utils.convert),
and sd_tpu's posterior draws (read off the keys it is given) go to the
port's steps as noise. Tolerances, each with its reason:

- VGG16's taps and LPIPS: max |diff| <= 1e-5 of the scale (fp32 convs
  summed in other orders);
- the discriminator's logits: 1e-5 of the scale; its BatchNorm running
  statistics: rtol 1e-5 (fp32 means over the batch);
- ``log_images_vae``: 1e-4 of the scale (fp32 through the autoencoder);
  ``BatchResizeWrapper``: exact (the same numpy draws and resize);
- the steps' losses, d_weight and logvar: rtol 1e-4 (fp32 through the
  autoencoder, LPIPS and the discriminator, and d_weight a ratio of two
  gradient norms);
- each step's gradients, read off Adam's first moments (mu = (1 - b1) g
  after one step) and second moments: max |diff| <= 1e-4 (mu) and 2e-4
  (nu) of max |ref| for each tensor whose gradient is at least 1e-3 of the
  module's largest, and below 1e-6 of it in both packages elsewhere (zero
  in exact arithmetic: where a GroupNorm group holds one channel, the conv
  bias before it; rounding noise in both);
- the parameters after the update, for the tensors compared above: the
  first Adam step moves each weight by lr * g / (|g| + eps), about
  lr * sign(g), so each tensor's update must be within 1e-3 * lr of
  sd_tpu's at all but 0.1% of its elements (where |g| is near 0 its sign is
  rounding noise), and within 2 * lr everywhere.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.models.vae import AutoencoderKL as JaxKL
from sd_tpu.models.vgg import VGG16Features as JaxVGG
from sd_tpu.training.discriminator import NLayerDiscriminator as JaxDisc
from sd_tpu.training.lpips import LPIPS as JaxLPIPS
from sd_tpu.training.trainer import log_images_vae as jax_log_images_vae
from sd_tpu.training.vae_gan import BatchResizeWrapper as JaxResize
from sd_tpu.training.vae_gan import VAEGANState as JaxState
from sd_tpu.training.vae_gan import VAEGANTrainer as JaxVAEGAN
from sd_tpu.utils import config as jconfig
from sd_tpu_torch.models.vae import AutoencoderKL
from sd_tpu_torch.models.vgg import VGG16Features
from sd_tpu_torch.scripts.train import build_trainer, parse_args
from sd_tpu_torch.utils.config import FIRST_STAGE_LOSS_KEYS
from sd_tpu_torch.training.discriminator import NLayerDiscriminator
from sd_tpu_torch.training.lpips import LPIPS
from sd_tpu_torch.training.trainer import DataModuleFromConfig, log_images_vae
from sd_tpu_torch.training.vae_gan import BatchResizeWrapper
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.testing import load_numpy_state_dict
from torch_parity import nchw, random_params, to_nhwc, torch_threads

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


_REPO = pathlib.Path(__file__).resolve().parents[1]
AE_CONFIG = _REPO / "configs/sd_tpu/tiny-autoencoder-kl.yaml"
IMAGE = (2, 32, 32, 3)


def _close_to_scale(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


def _images(seed, shape=IMAGE):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(np.float32)


def _lpips_params(seed):
    params = random_params(JaxLPIPS(), np.random.default_rng(seed), jnp.zeros((1, 32, 32, 3)),
                           jnp.zeros((1, 32, 32, 3)))
    # the released heads are non-negative
    return {k: ({"kernel": np.abs(v["kernel"])} if k.startswith("lin") else v)
            for k, v in params.items()}


def _disc_variables(seed):
    rng = np.random.default_rng(seed)
    params = random_params(JaxDisc(), rng, jnp.zeros((1, 32, 32, 3)))
    shapes = jax.eval_shape(lambda: JaxDisc().init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 32, 32, 3)))["batch_stats"])
    stats = {bn: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(np.float32),
                  "var": (1 + np.abs(rng.standard_normal(s["var"].shape))).astype(np.float32)}
             for bn, s in shapes.items()}
    return params, stats


def _port_disc(params, stats):
    return load_numpy_state_dict(NLayerDiscriminator(),
                                 convert.discriminator_state_dict(params, stats)).train()


# ---------------------------------------------------------------- modules


def test_vgg16_taps_and_lpips_match_sd_tpu():
    params = _lpips_params(0)
    x, y = _images(1), _images(2)
    lpips = load_numpy_state_dict(LPIPS(), convert.lpips_state_dict(params))
    vgg_sd = {k[len("vgg."):]: v for k, v in convert.lpips_state_dict(params).items()
              if k.startswith("vgg.")}
    vgg = load_numpy_state_dict(VGG16Features(), vgg_sd)
    want_taps = JaxVGG().apply({"params": params["vgg"]}, jnp.asarray(x))
    got_taps = vgg(nchw(x))
    assert set(got_taps) == set(want_taps)
    for name, want in want_taps.items():
        _close_to_scale(to_nhwc(got_taps[name]), want, 1e-5)
    want = JaxLPIPS().apply({"params": params}, jnp.asarray(x), jnp.asarray(y))
    got = lpips(nchw(x), nchw(y))
    assert got.shape == (2, 1, 1, 1)
    _close_to_scale(got.detach().numpy().reshape(2), np.asarray(want).reshape(2), 1e-5)
    assert not any(p.requires_grad for p in lpips.parameters())


def test_discriminator_in_training_mode_matches_sd_tpu():
    params, stats = _disc_variables(3)
    x = _images(4)
    want, new = JaxDisc().apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                train=True, mutable=["batch_stats"])
    disc = _port_disc(params, stats)
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    got_batch = disc(nchw(x), stats="batch")
    assert all(torch.equal(v, disc.state_dict()[k]) for k, v in before.items())
    got = disc(nchw(x), stats="update")
    torch.testing.assert_close(got, got_batch, rtol=0, atol=0)
    _close_to_scale(to_nhwc(got), want, 1e-5)
    sd = disc.state_dict()
    for bn, s in new["batch_stats"].items():
        i = 3 * int(bn.split("_")[1])
        np.testing.assert_allclose(sd[f"main.{i}.running_mean"].numpy(), s["mean"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(sd[f"main.{i}.running_var"].numpy(), s["var"], rtol=1e-5)
    want_eval = JaxDisc().apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                                train=False)
    _close_to_scale(to_nhwc(_port_disc(params, stats)(nchw(x), stats="running")), want_eval,
                    1e-5)


# ---------------------------------------------------------------- the steps


@pytest.fixture(scope="module")
def reference():
    """sd_tpu's VAEGANTrainer as main.py builds it from the tiny config,
    its random state, and its two steps compiled once."""
    cfg = jconfig.load_yaml(str(AE_CONFIG))
    p = cfg["model"]["params"]
    loss_cfg = p["lossconfig"]["params"]
    lr = cfg["data"]["params"]["batch_size"] * p["base_learning_rate"]
    model = JaxKL(ddconfig=p["ddconfig"], embed_dim=p["embed_dim"])
    lpips_params = _lpips_params(5)
    jtrainer = JaxVAEGAN(model=model, lpips=JaxLPIPS(), lpips_params=lpips_params,
                         learning_rate=lr,
                         **{k: v for k, v in loss_cfg.items() if k in FIRST_STAGE_LOSS_KEYS})
    ae_params = random_params(model, np.random.default_rng(6), jnp.zeros((1, 32, 32, 3)))
    disc_params, disc_stats = _disc_variables(7)
    state = JaxState(step=jnp.asarray(0, jnp.int32), ae_params=ae_params,
                     ae_opt=jtrainer.ae_tx.init(ae_params), disc_params=disc_params,
                     disc_stats=disc_stats, disc_opt=jtrainer.disc_tx.init(disc_params),
                     logvar=jnp.asarray(0.3, jnp.float32))
    return dict(cfg=cfg, trainer=jtrainer, state=state, lpips_params=lpips_params,
                generator_step=jax.jit(jtrainer.generator_step),
                discriminator_step=jax.jit(jtrainer.discriminator_step))


def _assert_adam_step_close(name, got_new, old, want_new, lr):
    got, want = np.asarray(got_new) - np.asarray(old), np.asarray(want_new) - np.asarray(old)
    off = np.abs(got - want)
    assert off.max() <= 2 * lr, name
    assert np.mean(off > 1e-3 * lr) <= 1e-3, (name, np.mean(off > 1e-3 * lr))


def _check_adam_step(module, optimizer, old, want_new, want_mu, want_nu, lr):
    """One module's first Adam step against sd_tpu's (see the tolerances)."""
    named = dict(module.named_parameters())
    largest = max(np.abs(w).max() for k, w in want_mu.items() if k in named)
    for name, p in named.items():
        st = optimizer.state[p]
        mu, nu = st["exp_avg"].numpy(), st["exp_avg_sq"].numpy()
        if np.abs(want_mu[name]).max() >= 1e-3 * largest > 0:
            _close_to_scale(mu, want_mu[name], 1e-4)
            _close_to_scale(nu, want_nu[name], 2e-4)
            _assert_adam_step_close(name, p.detach().numpy(), old[name], want_new[name], lr)
        else:
            assert np.abs(mu).max() <= 1e-6 * largest, name
            assert np.abs(want_mu[name]).max() <= 1e-6 * largest, name


@pytest.mark.parametrize("step", [0, 10], ids=["before_disc_start", "after_disc_start"])
def test_vae_gan_steps_match_sd_tpu(reference, tmp_path, step):
    harness, state, data = build_trainer(parse_args(
        ["--base", str(AE_CONFIG), "-t", "--device", "cpu", "--logdir", str(tmp_path)]))
    trainer = harness.trainer_obj
    jtrainer, jstate = reference["trainer"], reference["state"]._replace(
        step=jnp.asarray(step, jnp.int32))
    assert (trainer.disc_start, trainer.kl_weight, trainer.disc_weight) == (10, 1e-6, 0.5)
    assert trainer.learning_rate == jtrainer.learning_rate
    ddconfig = reference["cfg"]["model"]["params"]["ddconfig"]
    ae_sd = convert.vae_state_dict(jstate.ae_params, ddconfig)
    load_numpy_state_dict(state.ae, ae_sd).train()
    stats = jstate.disc_stats
    disc_sd = convert.discriminator_state_dict(jstate.disc_params, stats)
    load_numpy_state_dict(state.disc, disc_sd).train()
    load_numpy_state_dict(trainer.lpips, convert.lpips_state_dict(reference["lpips_params"]))
    with torch.no_grad():
        state.logvar.fill_(0.3)
    state.step = step
    batch = data.train_dataloader().batch(0)
    jbatch = {"image": jnp.asarray(batch["image"])}
    r1, r2 = jax.random.split(jax.random.PRNGKey(step))
    latent = (2, 16, 16, 4)
    noise_g = nchw(np.asarray(jax.random.normal(r1, latent)))
    noise_d = nchw(np.asarray(jax.random.normal(r2, latent)))
    lr = jtrainer.learning_rate

    jstate, want = reference["generator_step"](jstate, jbatch, r1)
    got = trainer.generator_step(state, batch, noise_g)
    assert float(want["disc_factor"]) == float(got["disc_factor"]) == (step >= 10)
    for key in ("total_loss", "nll_loss", "g_loss", "rec_loss", "d_weight", "kl_loss",
                "logvar"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, err_msg=key)
    adam = jstate.ae_opt[0]
    _check_adam_step(state.ae, state.ae_opt, ae_sd,
                     convert.vae_state_dict(jstate.ae_params, ddconfig),
                     convert.vae_state_dict(adam.mu, ddconfig),
                     convert.vae_state_dict(adam.nu, ddconfig), lr)

    jstate, want = reference["discriminator_step"](jstate, jbatch, r2)
    got = trainer.discriminator_step(state, batch, noise_d)
    for key in ("disc_loss", "logits_real", "logits_fake"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-4, atol=1e-7,
                                   err_msg=key)
    new_disc = convert.discriminator_state_dict(jstate.disc_params, jstate.disc_stats)
    for name, p in state.disc.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(p.numpy(), new_disc[name], rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    adam = jstate.disc_opt[0]
    if step >= 10:
        _check_adam_step(state.disc, state.disc_opt, disc_sd, new_disc,
                         convert.discriminator_state_dict(adam.mu, stats),
                         convert.discriminator_state_dict(adam.nu, stats), lr)
    else:  # disc_factor 0: a zero loss, zero gradients, no move
        assert float(got["disc_loss"]) == 0.0
        for name, p in state.disc.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), new_disc[name])


def test_log_images_vae_matches_sd_tpu(reference):
    """The first stage's image log, with sd_tpu's one draw from its key as
    both the posterior sample's noise and the decoded latents."""
    p = reference["cfg"]["model"]["params"]
    ae_params = reference["state"].ae_params
    model = load_numpy_state_dict(AutoencoderKL(p["ddconfig"], p["embed_dim"]),
                                  convert.vae_state_dict(ae_params, p["ddconfig"]))
    batch = {"image": _images(8, (3, 32, 32, 3))}
    key = jax.random.PRNGKey(3)
    want = jax_log_images_vae(reference["trainer"].model, ae_params, batch, key, n_row=2)
    noise = nchw(np.asarray(jax.random.normal(key, (2, 16, 16, 4))))
    got = log_images_vae(model, batch, noise, n_row=2)
    assert sorted(got) == sorted(want) == ["inputs", "reconstructions", "samples"]
    for name, w in want.items():
        assert got[name].shape == w.shape == (2, 32, 32, 3)
        _close_to_scale(got[name], w, 1e-4)


def test_batch_resize_wrapper_matches_sd_tpu():
    """Seven train batches (the first five at the largest size, then drawn
    sizes) and the validation batches, resized by MATLAB's bicubic."""
    images = {"target": "sd_tpu_torch.data.synthetic.SyntheticImages",
              "params": {"size": 32, "length": 14}}
    data = lambda: DataModuleFromConfig(batch_size=2, train=images, validation=images)
    port, ref = BatchResizeWrapper(data(), (16, 48), seed=3), JaxResize(data(), (16, 48), seed=3)
    got, want = list(port.train_dataloader()), list(ref.train_dataloader())
    assert [b["image"].shape[1] for b in got[:5]] == [48] * 5
    assert len({b["image"].shape[1] for b in got}) > 1
    for g, w in zip(got + list(port.val_dataloader()), want + list(ref.val_dataloader()),
                    strict=True):
        np.testing.assert_array_equal(g["image"], w["image"])
    with pytest.raises(ValueError):
        BatchResizeWrapper(data(), (16, 40))


# ------------------------------------------- the one-process reference of N ranks


def _tiny_kl(tmp_path, shards=1):
    """The CLI's tiny KL VAE-GAN (24² images, the discriminator from step 1)
    as the reference of ``shards`` ranks, and its first train batch."""
    harness, state, data = build_trainer(parse_args(
        ["--base", str(AE_CONFIG), "-t", "--device", "cpu", "--logdir", str(tmp_path),
         "--batch_size", "4", "model.params.lossconfig.params.disc_start=0",
         "data.params.train.params.size=24"]))
    harness.trainer_obj.shards = shards
    return harness.trainer_obj, state, data.train_dataloader().batch(0)


def _step_before_shards(trainer, state, batch, generator):
    """The one-process step as it was written before the ``shards`` option:
    the generator step, then the discriminator step, each with its noise."""
    from sd_tpu_torch.training.vae_gan import adopt_weight

    shape = trainer.posterior_shape(batch)
    noise_g = torch.randn(shape, generator=generator)
    noise_d = torch.randn(shape, generator=generator)
    x = trainer._images(batch)
    ae, disc = state.ae, state.disc
    disc.requires_grad_(False)
    state.ae_opt.zero_grad(set_to_none=True)
    state.logvar.grad = None
    nll, reg, rec_loss, rec, logs = trainer._reconstruction_terms(ae, x, noise_g, state.logvar)
    g_loss = -disc(rec, stats="batch").float().mean()
    last = ae.get_last_layer()
    g_nll = torch.autograd.grad(nll, last, retain_graph=True)[0]
    g_g = torch.autograd.grad(g_loss, last, retain_graph=True)[0]
    d_weight = torch.norm(g_nll.float()) / (torch.norm(g_g.float()) + 1e-4)
    d_weight = (d_weight.clamp(0.0, 1e4) * trainer.disc_weight).detach()
    disc_factor = adopt_weight(trainer.disc_factor, state.step, trainer.disc_start)
    loss = nll + trainer.kl_weight * reg + d_weight * disc_factor * g_loss
    loss.backward()
    state.ae_opt.step()
    with torch.no_grad():
        state.logvar -= trainer.learning_rate * state.logvar.grad
    disc.requires_grad_(True)
    with torch.no_grad():
        rec = ae(x, noise=noise_d)[0].float()
    state.disc_opt.zero_grad(set_to_none=True)
    logits_real, logits_fake = disc(x, stats="update").float(), disc(rec, stats="update").float()
    d_loss = disc_factor * trainer.d_loss_fn(logits_real, logits_fake)
    d_loss.backward()
    state.disc_opt.step()
    state.step += 1
    return {"total_loss": loss.detach(), "d_weight": d_weight, "disc_loss": d_loss.detach()}


def _flat_state(state):
    """Every tensor of a VAE-GAN state by name (optimizer moments too)."""
    sd = state.state_dict()
    out = {f"ae.{k}": v for k, v in sd["ae"].items()}
    out.update({f"disc.{k}": v for k, v in sd["disc"].items()})
    for opt in ("ae_opt", "disc_opt"):
        for i, st in sd[opt]["state"].items():
            out.update({f"{opt}.{i}.{k}": v for k, v in st.items()})
    out["logvar"] = sd["logvar"]
    return out


def test_reference_at_one_shard_is_the_plain_step_bit_for_bit(tmp_path):
    """``train_step`` at ``shards`` = 1 (every one-process run's step, and
    the reference of one rank) against the step as written before the
    option, 2 steps from one build's weights: every weight, moment,
    running statistic, the logvar and the losses equal."""
    runs = []
    for step in (lambda t, s, b, g: t.train_step(s, b, g), _step_before_shards):
        trainer, state, batch = _tiny_kl(tmp_path)
        logs = [{k: float(v) for k, v in step(trainer, state, batch,
                                              torch.Generator().manual_seed(i)).items()
                 if k in ("total_loss", "d_weight", "disc_loss")} for i in range(2)]
        runs.append((logs, _flat_state(state)))
    (got_logs, got), (want_logs, want) = runs
    assert got_logs == want_logs and got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want), [
        k for k in want if not torch.equal(got[k], want[k])]


def test_reference_at_two_shards_averages_each_shards_own_step(tmp_path):
    """One step of the reference of two ranks at batch 4 against two plain
    steps from the same weights, each on one shard's rows (``s::2``) with
    those rows of the same posterior draws (each discriminator step after
    the reference's autoencoder update, which both ranks take): Adam's first
    moments (the gradients times 1 - beta1) are the two steps' mean and the
    logvar's move their mean, within 1e-6 of the scale (fp32, the sums in
    another order); the running statistics are shard 0's, bit for bit, and
    so are the logs. A plain step at batch 4 is not the reference: its moments
    differ by more than 1e-3 of the scale (one d_weight, one batch's
    statistics)."""
    trainer, state, batch = _tiny_kl(tmp_path, shards=2)
    logvar0 = state.logvar.item()
    ref_logs = trainer.train_step(state, batch, torch.Generator().manual_seed(0))
    ref = _flat_state(state)
    ref_ae = state.ae.state_dict()
    g = torch.Generator().manual_seed(0)
    shape = trainer.posterior_shape(batch)
    noise_g, noise_d = torch.randn(shape, generator=g), torch.randn(shape, generator=g)
    shards = []
    for s in range(2):
        trainer, state, _ = _tiny_kl(tmp_path)
        rows = {"image": batch["image"][s::2]}
        logs = trainer.generator_step(state, rows, noise_g[s::2])
        state.ae.load_state_dict(ref_ae)
        logs.update(trainer.discriminator_step(state, rows, noise_d[s::2]))
        shards.append((logs, _flat_state(state)))
    plain, plain_state, _ = _tiny_kl(tmp_path)
    plain.train_step(plain_state, batch, torch.Generator().manual_seed(0))
    plain = _flat_state(plain_state)
    first = [k for k in ref if k.endswith(".exp_avg")]
    assert len(first) == len(list(state.ae.parameters())) + len(list(state.disc.parameters()))
    for k in first:
        mean = (shards[0][1][k] + shards[1][1][k]) / 2
        torch.testing.assert_close(ref[k], mean, rtol=0,
                                   atol=1e-6 * max(float(mean.abs().max()), 1e-30))
    scale = max(float(ref[k].abs().max()) for k in first)
    assert max(float((plain[k] - ref[k]).abs().max()) for k in first) > 1e-3 * scale
    moves = [float(st["logvar"]) - logvar0 for _, st in shards]
    assert float(ref["logvar"]) - logvar0 == pytest.approx(sum(moves) / 2, rel=1e-6)
    for k in ref:
        if "running" in k:
            assert torch.equal(ref[k], shards[0][1][k]), k
    for k in ("total_loss", "d_weight", "disc_loss", "rec_loss", "kl_loss"):
        assert float(ref_logs[k]) == float(shards[0][0][k]), k
