"""The port's noisy-latent classifier on the CPU against sd_tpu's, in fp32:
``EncoderUNetModel`` at every ``pool`` (with ``resblock_updown`` and the new
attention order among them) and ``AttentionPool2d`` from sd_tpu's
parameters carried across (``utils/convert.py::encoder_unet_state_dict``),
``compute_top_k``, one classifier step's loss and logs at sd_tpu's own t
and noise, and ``classifier_guidance_corrector``'s shifted ε, whose
gradient of log p(y | x_t) goes through ``torch.autograd.grad``.

Tolerances, each with its reason:

- the trunk's logits, the pooled features, the loss and the corrected ε:
  rtol 1e-4 and atol 1e-4 of the output's scale (fp32 convs, GroupNorm and
  softmax summed in other orders, as tests/test_torch_models.py);
- acc@k, t and the bucket keys: exact (the same counts and draws).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from sd_tpu.models.encoder_unet import EncoderUNetConfig as JaxConfig
from sd_tpu.models.encoder_unet import EncoderUNetModel as JaxEncoderUNet
from sd_tpu.ops.attention import AttentionPool2d as JaxPool
from sd_tpu.training import classifier as jclassifier
from sd_tpu_torch.core.schedules import DiffusionSchedule
from sd_tpu_torch.models.encoder_unet import EncoderUNetConfig, EncoderUNetModel
from sd_tpu_torch.ops.attention import AttentionPool2d
from sd_tpu_torch.training import classifier
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.testing import load_numpy_state_dict
from torch_parity import nchw, random_params, torch_threads

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


# a tiny trunk: 16² inputs, two levels, attention at 8², heads of 8
TINY = dict(in_channels=3, model_channels=32, out_channels=10, num_res_blocks=1,
            attention_resolutions=[2], channel_mult=[1, 2], num_head_channels=8,
            image_size=16)
POOLS = {"adaptive": {"resblock_updown": True}, "attention": {},
         "spatial": {"use_new_attention_order": True}, "spatial_v2": {}}


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _models(pool, seed=0, **extra):
    cfg = dict(TINY, pool=pool, **POOLS.get(pool, {}), **extra)
    jmodel = JaxEncoderUNet(JaxConfig.from_dict(cfg))
    params = random_params(jmodel, np.random.default_rng(seed), jnp.zeros((1, 16, 16, 3)),
                           jnp.zeros((1,)))
    model = load_numpy_state_dict(EncoderUNetModel(EncoderUNetConfig.from_dict(cfg)),
                                  convert.encoder_unet_state_dict(params, pool))
    return jmodel, params, model.eval()


def _inputs(seed=1, b=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 16, 16, 3)).astype(np.float32),
            rng.integers(0, 1000, b).astype(np.float32))


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_encoder_unet_matches_sd_tpu(pool):
    jmodel, params, model = _models(pool)
    x, t = _inputs()
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = model(nchw(x), torch.from_numpy(t))
    assert got.shape == (3, 10)
    _close(got.numpy(), want)


def test_attention_pool_matches_sd_tpu():
    jpool = JaxPool(spacial_dim=4, embed_dim=32, num_heads_channels=8, output_dim=6)
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 32)).astype(np.float32)
    params = random_params(jpool, np.random.default_rng(3), jnp.zeros((1, 4, 4, 32)))
    pool = load_numpy_state_dict(AttentionPool2d(4, 32, 8, 6),
                                 convert.attention_pool_state_dict(params))
    assert pool.positional_embedding.shape == (32, 17) and pool.num_heads == 4
    want = jax.jit(jpool.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = pool(nchw(x))
    assert got.shape == (2, 6)
    _close(got.numpy(), want)


def test_compute_top_k_matches_sd_tpu():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((64, 12)).astype(np.float32)
    labels = rng.integers(0, 12, 64)
    for k in (1, 3, 5, 12):
        got = float(classifier.compute_top_k(torch.from_numpy(logits), torch.from_numpy(labels),
                                             k))
        assert got == float(jclassifier.compute_top_k(jnp.asarray(logits),
                                                      jnp.asarray(labels), k))
    assert got == 1.0


def test_classifier_step_and_guidance_match_sd_tpu():
    jmodel, params, model = _models("attention", seed=5)
    schedule = DiffusionSchedule.create(timesteps=1000)
    jschedule = JaxSchedule.create(timesteps=1000)
    x, _ = _inputs(6, b=4)
    labels = np.array([0, 3, 9, 3])
    batch = {"image": x, "class_label": labels}

    jtrainer = jclassifier.NoisyLatentClassifierTrainer(model=jmodel, schedule=jschedule)
    key = jax.random.PRNGKey(7)
    loss_j, aux_j = jax.jit(jtrainer.loss_fn)(params, {k: jnp.asarray(v) for k, v in
                                                       batch.items()}, key)
    k_t, k_noise, _ = jax.random.split(key, 3)
    t = np.asarray(jax.random.randint(k_t, (4,), 0, 1000))
    noise = np.asarray(jax.random.normal(k_noise, x.shape))

    trainer = classifier.NoisyLatentClassifierTrainer(model=model, schedule=schedule)
    state = trainer.init_state()
    inputs, got_labels = trainer.inputs(batch)
    loss, aux = trainer.loss_at(inputs, got_labels, torch.from_numpy(t), nchw(noise))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-4)
    for k in ("acc@1", "acc@5", "t_mean"):
        assert float(aux[k]) == float(aux_j[k]), k
    # a step moves the weights, AdamW with weight decay; the buckets' keys
    before = state.model.time_embed[0].weight.detach().clone()
    logs = trainer.train_step(state, batch, torch.Generator().manual_seed(0))
    assert state.step == 1 and np.isfinite(float(logs["loss"]))
    assert not torch.equal(before, state.model.time_embed[0].weight)
    assert isinstance(state.optimizer, torch.optim.AdamW)
    buckets = trainer.eval_noise_buckets(state, batch, torch.Generator().manual_seed(1))
    assert sorted(buckets) == sorted(f"acc@1_t{int((i + 0.5) * 100)}" for i in range(10))
    assert state.model.training

    # classifier guidance: the shifted eps at sd_tpu's x_t and t
    target = np.array([1, 2, 3, 4])
    e_t = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    want = jclassifier.classifier_guidance_corrector(jmodel, params, jschedule,
                                                     jnp.asarray(target), scale=2.0)
    want = jax.jit(want)(jnp.asarray(e_t), jnp.asarray(x), jnp.asarray(t), None)
    fresh = _models("attention", seed=5)[2]  # the weights before the step
    corrector = classifier.classifier_guidance_corrector(fresh, schedule,
                                                         torch.from_numpy(target), scale=2.0)
    with torch.no_grad():  # as a sampler calls it
        got = corrector(nchw(e_t), nchw(x), torch.from_numpy(t), None)
    assert not torch.equal(got, nchw(e_t))
    _close(got.permute(0, 2, 3, 1).numpy(), want)
