"""The port's YAML-driven LDM training pieces on the CPU against sd_tpu's,
in fp32: the config layer (merge, dotlist, registry, refusals), the
trainable cond stages, the posterior's kl/nll, and the LDM trainer with a
trained cond stage, a learned logvar table, l1 loss and scale_by_std.

The same numpy inputs, weights (through sd_tpu_torch.utils.convert), t and
noise (sd_tpu's own draws, read off its key splits) go into both packages.
Tolerances, each with its reason:

- configs, ColoredShapes: exact (the same dict and numpy code);
- ClassEmbedder: exact (a table lookup);
- TransformerEmbedder (2 layers) and BERTEmbedder's nesting: max |diff|
  <= 1e-5 of the output scale (fp32 LayerNorm, attention and GELU summed in
  other orders);
- kl, nll and normal_kl: rtol 1e-5 (fp32 sums over a latent's elements);
- the LDM loss (l1, learned logvar) and its gradients on the UNet, the
  ClassEmbedder and the logvar table: loss rtol 1e-5, each gradient tensor
  max |diff| <= 1e-4 of max |ref| where its gradient is at least 1e-3 of
  the largest, and below 1e-6 of it in both packages elsewhere: those are
  zero in exact arithmetic (cross-attention over the one class token has a
  softmax of 1, so its Q, K and norm2 get none; where a GroupNorm group
  holds one channel, the biases before it get none, as in
  test_torch_train.py) and carry rounding noise;
- scale_by_std: rtol 1e-5 (the std of 2048 fp32 latents);
- ``log_images`` on the pixel-space model: 1e-4 of each array's scale
  (fp32 through the UNet, DDIM 4 steps), as test_torch_train_hooks.py.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sd_tpu.core.distributions import DiagonalGaussian as JaxGaussian
from sd_tpu.core.distributions import normal_kl as jax_normal_kl
from sd_tpu.data.synthetic import ColoredShapes as JaxColoredShapes
from sd_tpu.models import encoders as jenc
from sd_tpu.training import trainer as jtrainer
from sd_tpu.training.diffusion_loss import LDMTrainer as JaxLDMTrainer
from sd_tpu.utils import config as jconfig
from sd_tpu_torch.core.distributions import DiagonalGaussian, normal_kl
from sd_tpu_torch.data.synthetic import ColoredShapes
from sd_tpu_torch.models.encoders import BERTEmbedder, ClassEmbedder, TransformerEmbedder
from sd_tpu_torch.models.unet import UNetConfig
from sd_tpu_torch.scripts.train import build_trainer, parse_args
from sd_tpu_torch.training.trainer import log_images
from sd_tpu_torch.utils import config, convert
from sd_tpu_torch.utils.testing import load_numpy_state_dict
from torch_parity import nchw, random_params, torch_threads

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


_REPO = pathlib.Path(__file__).resolve().parents[1]
_CONFIGS = sorted((_REPO / "configs" / "sd_tpu").glob("*.yaml"))
# convergence-shapes.yaml at 16², with a trained ClassEmbedder, a learned
# logvar table from 0.5 and l1 loss
SHAPES_DOTLIST = ["model.params.image_size=16", "data.params.batch_size=2",
                  "data.params.train.params.size=16", "data.params.train.params.length=8",
                  "data.params.validation.params.size=16",
                  "data.params.validation.params.length=4",
                  "model.params.cond_stage_trainable=true", "model.params.learn_logvar=true",
                  "model.params.logvar_init=0.5", "model.params.loss_type=l1"]


def _close_to_scale(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max())


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("path", _CONFIGS, ids=lambda p: p.name)
def test_merge_and_dotlist_match_sd_tpu(path):
    base = jconfig.load_yaml(str(path))
    over = {"model": {"params": {"scale_factor": 0.5, "new_key": [1, 2],
                                 "first_stage_config": None}},
            "data": {"params": {"batch_size": 5}}}
    dotlist = ["model.params.base_learning_rate=1e-6", "model.params.use_ema=false",
               "data.params.batch_size=3", "lightning.trainer.max_epochs=2",
               "model.params.unet_config.params.channel_mult=[1,4]"]
    for configs in ([base], [base, over], [over, base]):
        want = jconfig.apply_dotlist(jconfig.merge_configs(configs), dotlist)
        assert config.apply_dotlist(config.merge_configs(configs), dotlist) == want
    assert config.load_yaml(str(path)) == base


def test_registry_builds_the_sd_tpu_configs_and_refuses_the_rest():
    shapes = config.load_yaml(str(_REPO / "configs/sd_tpu/convergence-shapes.yaml"))
    ldm = config.build_latent_diffusion(shapes["model"], device="cpu")
    assert type(ldm.first_stage_model).__name__ == "IdentityFirstStage"
    assert type(ldm.cond_stage_model).__name__ == "ClassEmbedder"
    assert ldm.cond_stage_key == "class_label"
    tiny = config.load_yaml(str(_REPO / "configs/sd_tpu/tiny-txt2img.yaml"))
    ldm = config.build_latent_diffusion(tiny["model"], device="cpu")
    assert type(ldm.cond_stage_model).__name__ == "TransformerEmbedder"
    data = config.instantiate_from_config(shapes["data"])
    assert type(data.train_dataloader().dataset).__name__ == "ColoredShapes"
    sched = config.instantiate_from_config(tiny["model"]["params"]["scheduler_config"])
    assert sched(0) == pytest.approx(1e-6) and sched(10) == pytest.approx(1.0)
    assert isinstance(config.instantiate_from_config({"target": "torch.nn.Identity"}),
                      torch.nn.Identity)
    rescaler = config.instantiate_from_config(
        {"target": "ldm.modules.encoders.modules.SpatialRescaler",
         "params": {"n_stages": 2, "method": "area", "out_channels": 4}})
    assert type(rescaler).__name__ == "SpatialRescaler"
    assert rescaler(torch.zeros(1, 3, 16, 16)).shape == (1, 4, 4, 4)
    # the VQ loss and the real datasets are registered (tests/test_torch_vq_train.py
    # and tests/test_torch_data.py build them); what the reference does not
    # ship is refused as unknown
    assert config.instantiate_from_config({
        "target": "ldm.modules.losses.vqperceptual.VQLPIPSWithDiscriminator",
        "params": {"codebook_weight": 1.0, "disc_conditional": False}}) == {
            "codebook_weight": 1.0}
    with pytest.raises(TypeError, match="data_root"):
        config.instantiate_from_config({"target": "ldm.data.imagenet.ImageNetTrain",
                                        "params": {}})
    with pytest.raises(KeyError, match="Unknown target"):
        config.instantiate_from_config({"target": "ldm.data.openimages.FullOpenImagesTrain"})
    # every conditioning key and both cond-stage sentinels build (the VQ
    # model and the routes themselves: tests/test_torch_vq.py and
    # tests/test_torch_inpaint_sample.py)
    for cond, key in (({"conditioning_key": "concat"}, "concat"),
                      ({"conditioning_key": "hybrid"}, "hybrid"),
                      ({"conditioning_key": "adm"}, "adm"),
                      ({"cond_stage_config": "__is_first_stage__"}, "crossattn"),
                      ({"cond_stage_config": "__is_unconditional__"}, None)):
        model = config.merge_configs([shapes["model"], {"params": cond}])
        ldm = config.build_latent_diffusion(model, device="meta")
        assert ldm.conditioning_key == key
        assert ldm.cond_stage_is_first_stage == (cond.get("cond_stage_config")
                                                 == "__is_first_stage__")
    with pytest.raises(KeyError, match="Unknown target"):
        config.instantiate_from_config({"target": "nowhere.Nothing"})


def test_colored_shapes_match_sd_tpu():
    port, ref = ColoredShapes(size=32, length=16, seed=3), JaxColoredShapes(size=32, length=16,
                                                                          seed=3)
    for i in range(16):
        a, b = port[i], ref[i]
        np.testing.assert_array_equal(a["image"], b["image"])
        assert a["class_label"] == b["class_label"]


# ------------------------------------------------------------ cond stages


def test_class_embedder_matches_sd_tpu():
    jmod = jenc.ClassEmbedder(embed_dim=16, n_classes=8)
    ids = np.array([3, 0, 7, 3], np.int32)
    params = random_params(jmod, np.random.default_rng(0), jnp.zeros((1,), jnp.int32))
    want = jmod.apply({"params": params}, jnp.asarray(ids))
    port = load_numpy_state_dict(ClassEmbedder(16, 8), convert.class_embedder_state_dict(params))
    got = port.encode(torch.from_numpy(ids))
    assert got.shape == (4, 1, 16)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("bert", [False, True])
def test_transformer_embedder_matches_sd_tpu(bert):
    kw = dict(n_embed=64, n_layer=2, vocab_size=50, max_seq_len=12)
    jmod = jenc.BERTEmbedder(**kw) if bert else jenc.TransformerEmbedder(**kw)
    tokens = np.random.default_rng(1).integers(0, 50, (2, 12)).astype(np.int32)
    params = random_params(jmod, np.random.default_rng(2), jnp.zeros((1, 12), jnp.int32))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(tokens)))
    port = (BERTEmbedder if bert else TransformerEmbedder)(**kw)
    load_numpy_state_dict(port, convert.transformer_embedder_state_dict(params, 2))
    got = port.encode(torch.from_numpy(tokens)).detach().numpy()
    _close_to_scale(got, want, 1e-5)


# ------------------------------------------------------------ distributions


def test_kl_nll_and_normal_kl_match_sd_tpu():
    rng = np.random.default_rng(4)
    moments = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)   # NHWC
    other = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    sample = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    jp, jo = JaxGaussian.from_moments(jnp.asarray(moments)), JaxGaussian.from_moments(
        jnp.asarray(other))
    tp, to = DiagonalGaussian.from_moments(nchw(moments)), DiagonalGaussian.from_moments(
        nchw(other))
    np.testing.assert_allclose(tp.kl().numpy(), np.asarray(jp.kl()), rtol=1e-5)
    np.testing.assert_allclose(tp.kl(to).numpy(), np.asarray(jp.kl(jo)), rtol=1e-5)
    np.testing.assert_allclose(tp.nll(nchw(sample)).numpy(), np.asarray(jp.nll(sample)),
                               rtol=1e-5)
    m1, l1, m2, l2 = (rng.standard_normal(6).astype(np.float32) for _ in range(4))
    np.testing.assert_allclose(normal_kl(*map(torch.from_numpy, (m1, l1, m2, l2))).numpy(),
                               np.asarray(jax_normal_kl(m1, l1, m2, l2)), rtol=1e-5)


# ------------------------------------------------------------ the LDM trainer


def _shapes_runs(tmp_path, extra=()):
    """The CLI's convergence-shapes run (SHAPES_DOTLIST), and sd_tpu's LDM
    of the same merged config, both with sd_tpu's random parameters."""
    opt = parse_args(["--base", str(_REPO / "configs/sd_tpu/convergence-shapes.yaml"), "-t",
                      "--device", "cpu", "--logdir", str(tmp_path), "--no_images"]
                     + SHAPES_DOTLIST + list(extra))
    harness, state, data = build_trainer(opt)
    cfg = jconfig.apply_dotlist(jconfig.merge_configs(
        [jconfig.load_yaml(str(_REPO / "configs/sd_tpu/convergence-shapes.yaml"))]),
        SHAPES_DOTLIST + list(extra))
    jldm = jconfig.build_latent_diffusion(cfg["model"], init_params=False)
    mp = cfg["model"]["params"]
    unet_p = mp["unet_config"]["params"]
    rng = np.random.default_rng(5)
    unet_params = random_params(jldm.unet, rng, jnp.zeros((1, 16, 16, 3)),
                                jnp.zeros((1,), jnp.int32),
                                jnp.zeros((1, 1, unet_p["context_dim"])))
    cond_params = random_params(jldm.cond_stage_model, rng, jnp.zeros((1,), jnp.int32))
    jldm = dataclasses.replace(jldm, unet_params=unet_params, cond_stage_params=cond_params)
    ldm = harness.trainer_obj.ldm
    ldm.model.diffusion_model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                                               for k, v in convert.unet_state_dict(
                                                   unet_params, UNetConfig.from_dict(unet_p)
                                               ).items()})
    ldm.cond_stage_model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in convert.class_embedder_state_dict(
            cond_params).items()})
    return harness, state, data, cfg, jldm


def test_ldm_trainer_trained_cond_stage_learned_logvar_l1_match_sd_tpu(tmp_path):
    harness, state, data, cfg, jldm = _shapes_runs(tmp_path)
    trainer = harness.trainer_obj
    mp = cfg["model"]["params"]
    assert trainer.train_cond_stage and trainer.learn_logvar and trainer.loss_type == "l1"
    assert set(state.trainables()) == (set(dict(trainer.unet.named_parameters()))
                                       | {"logvar", "cond_stage_model.embedding.weight"})
    jtrainer = JaxLDMTrainer(ldm=jldm, optimizer=optax.adamw(1e-3), train_cond_stage=True,
                             learn_logvar=True, logvar_init=float(mp["logvar_init"]),
                             loss_type="l1")
    params = jtrainer.init_state().params
    # a logvar table that is not constant, so that the gather by t shows
    table = (0.5 + 0.1 * np.random.default_rng(6).standard_normal(1000)).astype(np.float32)
    params = dict(params, logvar=jnp.asarray(table))
    with torch.no_grad():
        state.logvar.copy_(torch.from_numpy(table))
    batch = data.train_dataloader().batch(0)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(7)
    (want_loss, want_aux), want_grads = jax.jit(jax.value_and_grad(
        jtrainer.loss_fn, has_aux=True))(params, jbatch, key)
    # sd_tpu's draws: the identity first stage draws nothing from k_enc
    _, k_t, k_noise = jax.random.split(key, 3)
    t = np.asarray(jax.random.randint(k_t, (2,), 0, 1000))
    noise = np.asarray(jax.random.normal(k_noise, batch["image"].shape))

    z, cond = trainer.latents_and_cond(batch)
    loss, aux = trainer.loss_at(z, cond, torch.from_numpy(t.copy()), nchw(noise))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name in ("loss_simple", "loss_vlb"):
        np.testing.assert_allclose(aux[name].item(), float(want_aux[name]), rtol=1e-5)
    got = {"logvar": state.logvar.grad.numpy(),
           "embedding": trainer.ldm.cond_stage_model.embedding.weight.grad.numpy()}
    _close_to_scale(got["logvar"], want_grads["logvar"], 1e-4)
    assert np.count_nonzero(got["logvar"]) == len(set(t.tolist()))
    _close_to_scale(got["embedding"], want_grads["cond_stage"]["embedding"]["embedding"], 1e-4)
    want_unet = convert.unet_state_dict(want_grads["unet"],
                                        UNetConfig.from_dict(mp["unet_config"]["params"]))
    named = dict(trainer.unet.named_parameters())
    largest = max(np.abs(w).max() for w in want_unet.values())
    for name, w in want_unet.items():
        if np.abs(w).max() >= 1e-3 * largest:
            _close_to_scale(named[name].grad.numpy(), w, 1e-4)
        else:  # zero in exact arithmetic: rounding noise in both packages
            assert np.abs(named[name].grad.numpy()).max() < 1e-6 * largest, name
            assert np.abs(w).max() < 1e-6 * largest, name


def test_calibrate_scale_by_std_matches_sd_tpu_and_refuses_a_custom_scale(tmp_path):
    """scale_by_std on tiny-txt2img.yaml (a KL first stage) with its
    scale_factor set to 1, on the same batch and posterior noise."""
    base = str(_REPO / "configs/sd_tpu/tiny-txt2img.yaml")
    dotlist = ["model.params.scale_factor=1.0", "model.params.scale_by_std=true"]
    harness, state, data = build_trainer(parse_args(
        ["--base", base, "-t", "--device", "cpu", "--logdir", str(tmp_path), "--no_images"]
        + dotlist))
    trainer = harness.trainer_obj
    assert trainer.scale_by_std
    cfg = jconfig.apply_dotlist(jconfig.load_yaml(base), dotlist)
    jldm = jconfig.build_latent_diffusion(cfg["model"], init_params=False)
    ddconfig = cfg["model"]["params"]["first_stage_config"]["params"]["ddconfig"]
    fs_params = random_params(jldm.first_stage_model, np.random.default_rng(8),
                              jnp.zeros((1, 32, 32, 3)))
    jldm = dataclasses.replace(jldm, first_stage_params=fs_params)
    trainer.ldm.first_stage_model.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in convert.vae_state_dict(fs_params, ddconfig).items()})
    jtrainer = JaxLDMTrainer(ldm=jldm, optimizer=optax.adamw(1e-3), scale_by_std=True)
    batch = data.train_dataloader().batch(0)
    key = jax.random.PRNGKey(9)
    want = jtrainer.calibrate_scale_by_std({"image": jnp.asarray(batch["image"])}, key)
    posterior = jldm.encode_first_stage(jnp.asarray(batch["image"]))
    noise = np.asarray(jax.random.normal(key, posterior.mean.shape, posterior.mean.dtype))
    got = trainer.calibrate_scale_by_std(batch, noise=nchw(noise))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert trainer.ldm.scale_factor == got
    with pytest.raises(ValueError, match="std-rescaling"):
        trainer.calibrate_scale_by_std(batch, noise=nchw(noise))
    with pytest.raises(AssertionError):
        jtrainer.calibrate_scale_by_std({"image": jnp.asarray(batch["image"])}, key)


def test_log_images_on_the_pixel_space_class_model_matches_sd_tpu(tmp_path):
    """The image log of an IdentityFirstStage model conditioned on class
    labels (no posterior draw; the reconstruction is the input)."""
    harness, _, data, _, jldm = _shapes_runs(tmp_path)
    batch = data.train_dataloader().batch(0)
    key = jax.random.PRNGKey(11)
    want = jtrainer.log_images(jldm, batch, key, n_row=2, sample_steps=4)
    # sd_tpu's draws: split(key, 4) gives the samples' and the diffusion
    # row's keys (the posterior's goes unused); x_T is one split of its key
    _, _, k_samp, k_diff = jax.random.split(key, 4)
    shape = (2, 16, 16, 3)
    draws = {"sample": jax.random.normal(jax.random.split(k_samp)[1], shape),
             "diffusion": jax.random.normal(k_diff, shape)}
    ldm = harness.trainer_obj.ldm
    ldm.eval()
    got = log_images(ldm, batch, n_row=2, sample_steps=4, noise=draws)
    assert sorted(got) == sorted(want) == ["diffusion_row", "inputs", "reconstruction",
                                           "samples"]
    np.testing.assert_allclose(got["reconstruction"], batch["image"][:2], rtol=0, atol=1e-6)
    for name, w in want.items():
        _close_to_scale(got[name], w, 1e-4)
