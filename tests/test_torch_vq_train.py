"""The port's VQ first-stage (VQ-GAN) training on the CPU against sd_tpu's,
in fp32: ``measure_perplexity``, ``VAEGANTrainer``'s generator and
discriminator steps in VQ mode on a tiny VQModel (f2, 3 latent channels, 64
codes) from sd_tpu's parameters carried across, the VQ loss's
reconstruction term (the reference's, not sd_tpu's), ``log_images_vae`` on
the VQ model, the registry's ``VQLPIPSWithDiscriminator`` and one
``scripts/train.py --base`` run of a tiny VQ config.

The reconstruction term. sd_tpu's VQ mode reuses the KL loss's NLL,
``sum(rec_loss / exp(logvar) + logvar) / B`` with its trained ``logvar``;
the reference's ``VQLPIPSWithDiscriminator`` (and the port) takes
``mean(rec_loss)`` over every element and has no ``logvar``. The test holds
every other term equal to sd_tpu's and shows that the NLL, the adaptive
weight and the total differ by exactly that reduction and the ``logvar``
term. Tolerances, each with its reason:

- perplexity and cluster usage: rtol 1e-6 (an entropy of exact counts);
- the reconstruction loss per element, the discriminator's logits: max
  |diff| <= 1e-5 of the scale (fp32 convs summed in other orders);
- the code indices: equal (fp32 distances on both sides, codes at the
  latents' scale);
- losses, the adaptive weight and the discriminator's step: rtol 1e-4 (fp32
  through the autoencoder, LPIPS and the discriminator; d_weight a ratio of
  two gradient norms), the reference's NLL recovered from sd_tpu's at rtol
  1e-5;
- ``log_images_vae``: 1e-4 of the scale, as for the KL model.
"""

import json
import math
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.models.vae import VQModel as JaxVQ
from sd_tpu.training.lpips import LPIPS as JaxLPIPS
from sd_tpu.training.trainer import log_images_vae as jax_log_images_vae
from sd_tpu.training.vae_gan import VAEGANState as JaxState
from sd_tpu.training.vae_gan import VAEGANTrainer as JaxVAEGAN
from sd_tpu.training.vae_gan import measure_perplexity as jax_measure_perplexity
from sd_tpu_torch.models.vae import VQModel
from sd_tpu_torch.training.lpips import LPIPS
from sd_tpu_torch.training.trainer import log_images_vae
from sd_tpu_torch.training.vae_gan import VAEGANTrainer, measure_perplexity
from sd_tpu_torch.utils import config, convert
from sd_tpu_torch.utils.testing import load_numpy_state_dict
from test_torch_first_stage import _disc_variables, _lpips_params
from torch_parity import nchw, random_params, torch_threads

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


N_EMBED = 64
DDCONFIG = dict(double_z=False, z_channels=3, resolution=32, in_channels=3, out_ch=3, ch=32,
                ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[16], dropout=0.0)
LOGVAR = 0.3
LR = 1e-4


def _close_to_scale(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.parametrize("kind", ["uniform", "collapsed", "random"])
def test_measure_perplexity_matches_sd_tpu(kind):
    n = 16
    idx = {"uniform": np.arange(4 * n) % n, "collapsed": np.full(4 * n, 3),
           "random": np.random.default_rng(0).integers(0, n, 4 * n)}[kind]
    idx = idx.reshape(2, 4, 8)
    perplexity, usage = measure_perplexity(torch.from_numpy(idx), n)
    want_p, want_u = jax_measure_perplexity(jnp.asarray(idx), n)
    np.testing.assert_allclose(float(perplexity), float(want_p), rtol=1e-6)
    assert int(usage) == int(want_u)
    if kind == "uniform":
        assert int(usage) == n and float(perplexity) == pytest.approx(n, rel=1e-6)
    if kind == "collapsed":
        assert int(usage) == 1 and float(perplexity) == pytest.approx(1.0, abs=1e-6)


@pytest.fixture(scope="module")
def reference():
    """sd_tpu's VQ-mode VAEGANTrainer with random parameters (codes at the
    latents' scale), its state with a logvar of LOGVAR, and the port's
    trainer and state from the same parameters."""
    model = JaxVQ(ddconfig=DDCONFIG, n_embed=N_EMBED, embed_dim=3)
    ae_params = random_params(model, np.random.default_rng(1), jnp.zeros((1, 32, 32, 3)))
    ae_params["quantize"]["embedding"] = np.random.default_rng(2).standard_normal(
        (N_EMBED, 3)).astype(np.float32)
    lpips_params = _lpips_params(3)
    kw = dict(disc_start=0, disc_weight=0.75, codebook_weight=1.0, learning_rate=LR)
    jtrainer = JaxVAEGAN(model=model, lpips=JaxLPIPS(), lpips_params=lpips_params, **kw)
    assert jtrainer.is_vq
    disc_params, disc_stats = _disc_variables(4)
    jstate = JaxState(step=jnp.asarray(0, jnp.int32), ae_params=ae_params,
                      ae_opt=jtrainer.ae_tx.init(ae_params), disc_params=disc_params,
                      disc_stats=disc_stats, disc_opt=jtrainer.disc_tx.init(disc_params),
                      logvar=jnp.asarray(LOGVAR, jnp.float32))

    def port():
        vq = load_numpy_state_dict(VQModel(DDCONFIG, N_EMBED, 3),
                                   convert.vq_state_dict(ae_params, DDCONFIG))
        lpips = load_numpy_state_dict(LPIPS(), convert.lpips_state_dict(lpips_params))
        trainer = VAEGANTrainer(model=vq, lpips=lpips, **kw)
        state = trainer.init_state()
        load_numpy_state_dict(state.disc, convert.discriminator_state_dict(
            disc_params, disc_stats)).train()
        return trainer, state

    return dict(model=model, trainer=jtrainer, state=jstate, port=port,
                lpips_params=lpips_params)


def test_vq_gan_terms_match_sd_tpu_and_the_reconstruction_term_is_the_references(reference):
    jtrainer, jstate = reference["trainer"], reference["state"]
    trainer, state = reference["port"]()
    assert trainer.is_vq and state.logvar is None
    x = np.random.default_rng(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    batch = {"image": x}
    key = jax.random.PRNGKey(0)

    # the forward terms, on the same reconstruction (one JAX program)
    @jax.jit
    def terms(st, x):
        rec, qloss, idx = jtrainer.model.apply({"params": st.ae_params}, x)
        _, rec_loss = jtrainer._rec_nll(x, rec, st.logvar)
        g_loss = -jnp.mean(jtrainer._disc_logits(st.disc_params, st.disc_stats, rec))
        return (rec_loss, qloss, idx, g_loss) + jax_measure_perplexity(idx, N_EMBED)

    rec_loss_j, qloss_j, idx_j, g_loss_j, perp_j, usage_j = terms(jstate, jnp.asarray(x))
    with torch.no_grad():
        rec, qloss, idx = state.ae(nchw(x))
        rec_loss, _ = trainer._rec_loss(nchw(x), rec, 1.0)
        g_loss = -state.disc(rec, stats="batch").mean()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert 1 < len(np.unique(np.asarray(idx_j))) < N_EMBED
    _close_to_scale(rec_loss.permute(0, 2, 3, 1).numpy(), rec_loss_j, 1e-5)
    for got, want in ((qloss, qloss_j), (g_loss, g_loss_j)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)

    # the generator step's logs
    jstate_g, want = jax.jit(jtrainer.generator_step)(jstate, {"image": jnp.asarray(x)}, key)
    got = trainer.generator_step(state, batch)
    for k in ("g_loss", "quant_loss", "rec_loss", "perplexity"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(got["perplexity"]), float(perp_j), rtol=1e-6)
    assert int(got["cluster_usage"]) == int(want["cluster_usage"]) == int(usage_j)
    assert float(got["disc_factor"]) == float(want["disc_factor"]) == 1.0
    assert "logvar" not in got and "kl_loss" not in got

    # the fault: sd_tpu's NLL is sum(rec_loss / exp(logvar) + logvar) / B;
    # the reference's is the mean of rec_loss over all N elements
    b, n = x.shape[0], x.size
    want_nll = (float(want["nll_loss"]) * b - LOGVAR * n) * math.exp(LOGVAR) / n
    np.testing.assert_allclose(float(got["nll_loss"]), want_nll, rtol=1e-5)
    np.testing.assert_allclose(float(got["nll_loss"]), float(rec_loss.mean()), rtol=1e-6)
    # both adaptive weights from the same two gradients: the NLL's gradient
    # at the last layer scales by B exp(logvar) / N, the generator loss's is
    # the same, so the weights keep that ratio
    ratio = b * math.exp(LOGVAR) / n
    np.testing.assert_allclose(float(got["d_weight"]), float(want["d_weight"]) * ratio,
                               rtol=1e-4)
    # and each total is its NLL + the codebook term + the weighted GAN term
    for log, nll in ((got, float(got["nll_loss"])), (want, float(want["nll_loss"]))):
        total = nll + float(log["quant_loss"]) + float(log["d_weight"]) * float(log["g_loss"])
        np.testing.assert_allclose(float(log["total_loss"]), total, rtol=1e-5)
    assert abs(float(want["total_loss"]) - float(got["total_loss"])) > 1.0

    # the discriminator step, from the same starting weights in both
    trainer, state = reference["port"]()
    jstate_d, want = jax.jit(jtrainer.discriminator_step)(jstate, {"image": jnp.asarray(x)},
                                                          key)
    got = trainer.discriminator_step(state, batch)
    for k in ("disc_loss", "logits_real", "logits_fake"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_log_images_vae_on_a_vq_model_matches_sd_tpu(reference):
    model, ae_params = reference["model"], reference["state"].ae_params
    trainer, _ = reference["port"]()
    batch = {"image": np.random.default_rng(6).uniform(-1, 1, (3, 32, 32, 3)).astype(
        np.float32)}
    key = jax.random.PRNGKey(4)
    want = jax_log_images_vae(model, ae_params, batch, key, n_row=2)
    noise = nchw(np.asarray(jax.random.normal(key, (2, 16, 16, 3))))
    got = log_images_vae(trainer.model, batch, noise, n_row=2)
    assert sorted(got) == sorted(want) == ["inputs", "reconstructions", "samples"]
    for name, w in want.items():
        _close_to_scale(got[name], w, 1e-4)


def test_registry_builds_the_vq_loss():
    params = {"disc_conditional": False, "disc_in_channels": 3, "disc_start": 0,
              "disc_weight": 0.75, "codebook_weight": 1.0, "pixel_loss": "l2"}
    for target in ("taming.modules.losses.vqperceptual.VQLPIPSWithDiscriminator",
                   "ldm.modules.losses.vqperceptual.VQLPIPSWithDiscriminator"):
        got = config.instantiate_from_config({"target": target, "params": params})
        assert got == {"disc_in_channels": 3, "disc_start": 0, "disc_weight": 0.75,
                       "codebook_weight": 1.0, "pixel_loss": "l2"}
    vq = config.load_yaml(str(pathlib.Path(__file__).resolve().parents[1]
                              / "sd_tpu_torch/configs/vq-f4.yaml"))
    loss = config.instantiate_from_config(vq["model"]["params"]["lossconfig"])
    assert loss == {"disc_in_channels": 3, "disc_start": 0, "disc_weight": 0.75,
                    "codebook_weight": 1.0}


def test_train_cli_trains_a_vq_first_stage(tmp_path):
    from sd_tpu_torch.scripts.train import build_trainer, main, parse_args

    images = {"target": "sd_tpu_torch.data.synthetic.SyntheticImages",
              "params": {"size": 32, "length": 4}}
    cfg = {"model": {"base_learning_rate": 4.5e-6, "target": "ldm.models.autoencoder.VQModel",
                     "params": {"embed_dim": 3, "n_embed": N_EMBED, "ddconfig": DDCONFIG,
                                "batch_resize_range": [16, 32],
                                "lossconfig": {
                                    "target": "taming.modules.losses.vqperceptual."
                                              "VQLPIPSWithDiscriminator",
                                    "params": {"disc_start": 1, "disc_weight": 0.75,
                                               "codebook_weight": 1.0}}}},
           "data": {"params": {"batch_size": 2, "train": images}}}
    path = tmp_path / "vq.yaml"
    path.write_text(json.dumps(cfg))
    argv = ["--base", str(path), "-t", "--device", "cpu", "-l", str(tmp_path / "logs"),
            "--max_steps", "2", "--log_every", "1"]
    harness, state, _ = build_trainer(parse_args(argv))
    assert harness.trainer_obj.is_vq and state.logvar is None
    assert (harness.trainer_obj.disc_start, harness.trainer_obj.codebook_weight) == (1, 1.0)
    logs = []
    step = VAEGANTrainer.train_step

    def logged(self, *a):
        out = step(self, *a)
        logs.append({k: float(v) for k, v in out.items()})
        return out

    VAEGANTrainer.train_step = logged
    try:
        main(argv)
    finally:
        VAEGANTrainer.train_step = step
    assert len(logs) == 2 and all(np.isfinite(list(log.values())).all() for log in logs)
    assert logs[0]["disc_factor"] == 0.0 and logs[1]["disc_factor"] == 1.0
    assert all(1 <= log["cluster_usage"] <= N_EMBED and log["perplexity"] >= 1 for log in logs)
    assert (tmp_path / "logs").exists()
