"""The port's training slice on the CPU against sd_tpu's, in fp32.

The same numpy inputs, weights (through sd_tpu_torch.utils.convert), t and
noise go into both packages. Tolerances, each with its reason:

- ``p_losses`` and the tiny UNet's gradients: per tensor max |diff| <=
  1e-4 * max |ref| (fp32 through a few dozen layers, summed in other orders,
  and the timestep frequencies differ by up to an ulp between the two). A
  tensor's scale is at least 1e-3 of the largest gradient's: where the tiny
  UNet has 32 channels, each GroupNorm group holds one channel and cancels a
  per-channel shift, so the conv biases and timestep projections before such
  a norm have a zero gradient in exact arithmetic, and rounding noise of
  ~2e-8 of the largest gradient in both packages (every other tensor's
  gradient is above 3e-3 of it);
- the VAE encoder's moments: rtol 1e-4, atol 1e-4 of their scale (as the
  decoder's test in test_torch_models.py);
- AdamW + LambdaLinear and the EMA: rtol 1e-5, atol 1e-6 (the same fp32
  update rule; the schedules are float32 in JAX and float64 here);
- the posterior sample, q_sample, the schedules' multipliers: rtol 1e-6;
- the tokenizer, the data pipeline and the watermark copy: exact.

Also: ``Trainer.fit`` resumes exactly (4 steps equal 2 steps, a checkpoint, a
resume and 2 more), and the training CLI runs in a fresh interpreter that
imports neither jax, flax nor sd_tpu. The training loop's hooks are in
test_torch_train_hooks.py.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sd_tpu.core.distributions import DiagonalGaussian as JaxGaussian
from sd_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from sd_tpu.core.schedules import q_sample as jax_q_sample
from sd_tpu.data.base import DataLoader as JaxDataLoader
from sd_tpu.data.synthetic import SyntheticImages as JaxSyntheticImages
from sd_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from sd_tpu.models import unet as junet
from sd_tpu.models import vae as jvae
from sd_tpu.training import diffusion_loss as jloss
from sd_tpu.training import ema as jema
from sd_tpu.training import lr_schedules as jsched
from sd_tpu.utils.watermark import embed_watermark_batch as jax_watermark
from sd_tpu_torch.core.distributions import DiagonalGaussian
from sd_tpu_torch.core.schedules import DiffusionSchedule, q_sample
from sd_tpu_torch.data.base import DataLoader
from sd_tpu_torch.data.synthetic import SyntheticImages
from sd_tpu_torch.data.tokenizer import HashTokenizer
from sd_tpu_torch.models.unet import UNetConfig, UNetModel
from sd_tpu_torch.models.vae import AutoencoderKL
from sd_tpu_torch.scripts.train import build_trainer, parse_args
from sd_tpu_torch.training import lr_schedules
from sd_tpu_torch.training.diffusion_loss import make_optimizer, p_losses
from sd_tpu_torch.training.ema import ema_init, ema_update
from sd_tpu_torch.utils import convert
from sd_tpu_torch.utils.config import tiny_sd_model_config
from sd_tpu_torch.utils.testing import load_numpy_state_dict, randomize_tree
from sd_tpu_torch.utils.watermark import embed_watermark_batch
from torch_parity import torch_threads

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


_REPO = pathlib.Path(__file__).resolve().parents[1]
_TINY = tiny_sd_model_config()["params"]
UNET_P = _TINY["unet_config"]["params"]
DDCONFIG = dict(_TINY["first_stage_config"]["params"]["ddconfig"], attn_resolutions=[16])


def _init(module, seed, *args, **kw):
    variables = module.init(jax.random.PRNGKey(0), *args, **kw)
    return randomize_tree(variables["params"], np.random.default_rng(seed))


def _schedules():
    kw = dict(timesteps=1000, linear_start=_TINY["linear_start"], linear_end=_TINY["linear_end"])
    return JaxSchedule.create(**kw), DiffusionSchedule.create(**kw)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


# ---------------------------------------------------------------- the loss


def test_p_losses_and_unet_gradients_match_jax():
    """Loss and every tiny-UNet gradient against jax.value_and_grad, with the
    logvar term and the ELBO term switched on."""
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    noise = rng.standard_normal((2, 16, 16, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, 32)).astype(np.float32)
    logvar = (0.1 * rng.standard_normal(1000)).astype(np.float32)
    t = np.array([17, 633], np.int32)
    jsch, sch = _schedules()
    kw = dict(original_elbo_weight=0.5, l_simple_weight=0.7)

    jmodel = junet.UNetModel(junet.UNetConfig.from_dict(UNET_P))
    params = _init(jmodel, 1, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(ctx))

    def loss_of(p):
        apply = lambda x, tt, c: jmodel.apply({"params": p}, x, tt, c)
        return jloss.p_losses(apply, jsch, jnp.asarray(x0), jnp.asarray(ctx), jnp.asarray(t),
                              jnp.asarray(noise), logvar=jnp.asarray(logvar), **kw)[0]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_of))(params)
    cfg = UNetConfig.from_dict(UNET_P)
    unet = load_numpy_state_dict(UNetModel(cfg), convert.unet_state_dict(params, cfg)).train()
    loss, aux = p_losses(unet, sch, _nchw(x0), torch.from_numpy(ctx),
                         torch.from_numpy(t).long(), _nchw(noise),
                         logvar=torch.from_numpy(logvar), **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert set(aux) == {"loss", "loss_simple", "loss_vlb"}
    want = convert.unet_state_dict(jax.tree.map(np.asarray, want_grads), cfg)
    got = {n: p.grad.numpy() for n, p in unet.named_parameters()}
    assert sorted(got) == sorted(want)
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        scale = max(np.abs(w).max(), 1e-3 * top)
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-4 * scale, err_msg=name)


def test_use_checkpoint_recomputes_to_the_same_gradients():
    """The tiny UNet with use_checkpoint runs each ResBlock and
    SpatialTransformer again in the backward, and gives the gradients of the
    plain run."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 4, 16, 16)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32))
    t = torch.tensor([3, 700])
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        unet = UNetModel(UNetConfig.from_dict(dict(UNET_P, use_checkpoint=remat))).train()
        # the first op of a ResBlock and of a SpatialTransformer (the recompute
        # stops once it has what the backward needs, so hooks on the blocks
        # themselves do not run again)
        calls = []
        for name, op in (("res", unet.input_blocks[1][0].in_layers[0]),
                         ("attn", unet.input_blocks[3][1].norm)):
            op.register_forward_hook(lambda *_, name=name: calls.append(name))
        unet(x, t, ctx).square().mean().backward()
        assert sorted(calls) == sorted(["res", "attn"] * (2 if remat else 1))
        grads.append({n: p.grad for n, p in unet.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("loss_type,with_logvar,elbo", [
    ("l2", False, 0.0), ("l1", False, 0.0), ("l2", True, 1.0), ("l1", True, 0.25)])
def test_p_losses_terms_match_jax(loss_type, with_logvar, elbo):
    """Each term of the loss, with a model that is a fixed elementwise map."""
    rng = np.random.default_rng(1)
    x0, noise = (rng.standard_normal((3, 8, 8, 4)).astype(np.float32) for _ in range(2))
    logvar = (0.3 * rng.standard_normal(1000)).astype(np.float32) if with_logvar else None
    t = np.array([0, 500, 999], np.int32)
    jsch, sch = _schedules()
    kw = dict(loss_type=loss_type, original_elbo_weight=elbo)
    want_loss, want = jloss.p_losses(
        lambda x, tt, c: jnp.tanh(x) * 0.5, jsch, jnp.asarray(x0), None, jnp.asarray(t),
        jnp.asarray(noise), logvar=None if logvar is None else jnp.asarray(logvar), **kw)
    got_loss, got = p_losses(
        lambda x, tt, c: torch.tanh(x) * 0.5, sch, _nchw(x0), None, torch.from_numpy(t).long(),
        _nchw(noise), logvar=None if logvar is None else torch.from_numpy(logvar), **kw)
    for key in ("loss", "loss_simple", "loss_vlb"):
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-5, err_msg=key)


def test_q_sample_matches_jax():
    rng = np.random.default_rng(2)
    x0, noise = (rng.standard_normal((3, 8, 8, 4)).astype(np.float32) for _ in range(2))
    t = np.array([0, 321, 999], np.int32)
    jsch, sch = _schedules()
    want = jax_q_sample(jsch, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = q_sample(sch, _nchw(x0), torch.from_numpy(t), _nchw(noise))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ------------------------------------------------------- the first stage


def test_vae_encoder_moments_match_jax():
    """The tiny f2 encoder with attention in its 16x16 level, plus the
    mid-block attention and quant_conv."""
    x = np.random.default_rng(3).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    jmodel = jvae.AutoencoderKL(ddconfig=DDCONFIG, embed_dim=4)
    params = _init(jmodel, 4, jnp.zeros((1, 32, 32, 3)))
    want = jmodel.apply({"params": params}, jnp.asarray(x), method=jmodel.encode)
    ae = load_numpy_state_dict(AutoencoderKL(DDCONFIG, 4), convert.vae_state_dict(params, DDCONFIG))
    with torch.no_grad():
        got = ae.encode(_nchw(x))
    for g, w in ((got.mean, want.mean), (got.logvar, want.logvar)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_diagonal_gaussian_sample_with_injected_noise():
    rng = np.random.default_rng(5)
    moments = rng.standard_normal((2, 4, 4, 8)).astype(np.float32) * 20  # clamps both ways
    noise = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    want = JaxGaussian.from_moments(jnp.asarray(moments))
    got = DiagonalGaussian.from_moments(_nchw(moments))
    want_sample = np.asarray(want.mean + want.std * jnp.asarray(noise))
    to_nhwc = lambda t: t.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(to_nhwc(got.logvar), np.asarray(want.logvar), rtol=1e-6)
    np.testing.assert_allclose(to_nhwc(got.sample(noise=_nchw(noise))), want_sample, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(to_nhwc(got.mode()), np.asarray(want.mode()))
    draw = got.sample(torch.Generator().manual_seed(0))
    assert draw.shape == got.mean.shape and not torch.equal(draw, got.mean)


# ------------------------------------------------------- optimizer and EMA


def test_adamw_with_lambda_linear_matches_optax():
    """Five steps of the port's AdamW + LambdaLR on fixed gradients against
    optax.adamw (its default weight decay 1e-4) with sd_tpu's schedule."""
    rng = np.random.default_rng(6)
    shapes = {"w": (8, 4), "b": (4,)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    sched = dict(warm_up_steps=[3], f_min=[0.5], f_max=[1.0], f_start=[0.1],
                 cycle_lengths=[10])
    base_lr = 1e-2
    jfn = jsched.lambda_linear(**sched)
    tx = optax.adamw(lambda s: base_lr * jfn(s))
    params = jax.tree.map(jnp.asarray, init)
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, params)
        params = optax.apply_updates(params, updates)

    tparams = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in init.items()}
    optimizer, scheduler = make_optimizer(list(tparams.values()), base_lr,
                                          lr_schedules.lambda_linear(**sched))
    for g in grads:
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        optimizer.step()
        scheduler.step()
    for k in shapes:
        np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(params[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name,args", [
    ("lambda_warmup_cosine", (100, 0.1, 1.0, 0.01, 1000)),
    ("lambda_warmup_cosine2", ([50, 20], [0.1, 0.2], [1.0, 0.8], [0.0, 0.1], [300, 400])),
    ("lambda_linear", ([50, 20], [0.1, 0.2], [1.0, 0.8], [0.0, 0.1], [300, 400])),
])
def test_lr_schedules_match_jax(name, args):
    want, got = getattr(jsched, name)(*args), getattr(lr_schedules, name)(*args)
    for step in (0, 1, 25, 49, 50, 51, 99, 100, 299, 300, 301, 500, 699, 700, 2000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-7,
                                   err_msg=str(step))


def test_ema_matches_jax():
    rng = np.random.default_rng(7)
    params = [{"a": rng.standard_normal((5, 3)).astype(np.float32),
               "b": rng.standard_normal(3).astype(np.float32)} for _ in range(6)]
    jstate = jema.ema_init(jax.tree.map(jnp.asarray, params[0]), decay=0.99)
    state = ema_init({k: torch.from_numpy(v) for k, v in params[0].items()}, decay=0.99)
    for p in params[1:]:
        jstate = jema.ema_update(jstate, jax.tree.map(jnp.asarray, p))
        ema_update(state, {k: torch.from_numpy(v) for k, v in p.items()})
    assert state.num_updates == int(jstate.num_updates) == 5
    for k in ("a", "b"):
        np.testing.assert_allclose(state.shadow[k].numpy(), np.asarray(jstate.shadow[k]),
                                   rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- data and text


def test_synthetic_data_and_loader_match_jax():
    """Two epochs of shuffled batches, item for item."""
    kw = dict(size=8, length=10, caption_tokens=8, caption_vocab=64, seed=3)
    want = JaxDataLoader(JaxSyntheticImages(**kw), batch_size=3, shuffle=True, seed=5)
    got = DataLoader(SyntheticImages(**kw), batch_size=3, shuffle=True, seed=5)
    assert len(got) == len(want) == 3
    for _ in range(2):
        batches = list(zip(list(got), list(want)))  # each loader runs to its epoch's end
        assert len(batches) == 3
        for g, w in batches:
            assert sorted(g) == sorted(w)
            for key in w:
                np.testing.assert_array_equal(g[key], w[key])
    assert got.epoch == want.epoch == 2


def test_synthetic_captions_go_under_the_cond_stage_key():
    item = SyntheticImages(size=8, caption_tokens=77, caption_vocab=49408, caption_key="txt")[0]
    assert item["txt"].shape == (77,) and item["txt"].dtype == np.int32 and "caption" not in item


def test_tokenizer_copy_gives_the_same_ids():
    texts = ["a painting of a virus monster playing guitar", "", "A  Red&amp;Cube",
             " ".join(["word"] * 100)]
    for vocab, length in ((49408, 77), (64, 8)):
        np.testing.assert_array_equal(HashTokenizer(vocab)(texts, context_length=length),
                                      JaxHashTokenizer(vocab)(texts, context_length=length))


def test_watermark_copy_gives_the_same_images():
    imgs = np.random.default_rng(8).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(embed_watermark_batch(imgs), jax_watermark(imgs))


# ------------------------------------------------------- the trainer


def _tiny_run(logdir, max_steps, resume=False):
    harness, state, data = build_trainer(parse_args(
        ["--tiny", "--device", "cpu", "--seed", "3", "--logdir", str(logdir), "--max_steps",
         str(max_steps), "--batch_size", "2", "--log_every", "1", "--no_images"]
        + (["--resume"] if resume else [])))
    harness.fit(state, data, resume=resume)
    return state


def test_trainer_resume_is_exact(tmp_path):
    """4 steps in one run equal 2 steps, a checkpoint, a resume and 2 more:
    the same UNet weights, AdamW moments and EMA shadow, bit for bit. With 64
    images at batch 2 the resume lands mid-epoch."""
    whole = _tiny_run(tmp_path / "whole", 4)
    _tiny_run(tmp_path / "split", 2)
    split = _tiny_run(tmp_path / "split", 4, resume=True)
    assert whole.step == split.step == 4
    for (name, a), b in zip(whole.unet.state_dict().items(), split.unet.state_dict().values()):
        assert torch.equal(a, b), name
    for k, v in whole.ema.shadow.items():
        assert torch.equal(v, split.ema.shadow[k]), k
    for pa, pb in zip(whole.unet.parameters(), split.unet.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(whole.optimizer.state[pa][key], split.optimizer.state[pb][key])
    assert whole.scheduler is None  # the tiny config has no LR schedule
    initial = _tiny_run(tmp_path / "none", 0)
    assert not all(torch.equal(a, b) for a, b in zip(initial.unet.parameters(),
                                                     whole.unet.parameters()))


def test_gradient_accumulation_averages_the_microbatches(tmp_path):
    """With accumulate_grad_batches=2 the step's gradient is the mean of the
    two half batches' gradients, each drawn in turn from the step's
    generator (exact up to the order of the sum)."""
    harness, state, data = build_trainer(parse_args(
        ["--tiny", "--device", "cpu", "--logdir", str(tmp_path), "--batch_size", "4"]))
    trainer = harness.trainer_obj
    batch = {k: v for k, v in next(iter(data.train_dataloader())).items()
             if k in ("image", "caption")}
    generator = torch.Generator().manual_seed(1)
    want = {}
    for half in (slice(0, 2), slice(2, 4)):
        trainer.unet.zero_grad(set_to_none=True)
        loss, _ = trainer.loss_fn({k: v[half] for k, v in batch.items()}, generator)
        loss.backward()
        for name, p in trainer.unet.named_parameters():
            want[name] = want.get(name, 0) + p.grad / 2
    trainer.accumulate_grad_batches = 2
    trainer.train_step(state, batch, torch.Generator().manual_seed(1))
    for name, p in trainer.unet.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=1e-6, atol=1e-9, msg=name)


def test_train_state_precision_and_optimizer_on_the_cpu(tmp_path):
    harness, state, _ = build_trainer(parse_args(
        ["--device", "cpu", "--tiny", "--logdir", str(tmp_path)]))
    ldm = harness.trainer_obj.ldm
    assert all(p.dtype == torch.float32 for p in ldm.parameters())
    assert all(p.requires_grad for p in state.unet.parameters())
    assert not any(p.requires_grad for p in ldm.first_stage_model.parameters())
    assert not any(p.requires_grad for p in ldm.cond_stage_model.parameters())
    group = state.optimizer.param_groups[0]
    assert (group["betas"], group["eps"], group["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-4)
    assert group["lr"] == pytest.approx(2e-4)  # scale_learning_rate: batch 2 x 1e-4
    assert state.unet.training and state.unet.config.use_checkpoint is False


def test_sd_v1_lr_schedule_is_lambda_linear():
    """SD v1's scheduler_config: warmup from 1e-6 of the LR over 10,000 steps."""
    fn = lr_schedules.lambda_linear(warm_up_steps=[10000], cycle_lengths=[10000000000000],
                                    f_start=[1.e-6], f_max=[1.], f_min=[1.])
    assert fn(0) == pytest.approx(1e-6) and fn(10000) == pytest.approx(1.0)
    assert fn(5000) == pytest.approx(0.5, rel=1e-5)


def test_training_cli_runs_without_jax(tmp_path):
    """The training CLI, in a fresh interpreter, imports neither jax, flax nor
    sd_tpu, and leaves a checkpoint at the last step."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['train', '--tiny', '--device', 'cpu', '--max_steps', '2', '--no_images',"
        f" '--logdir', {str(tmp_path)!r}]\n"
        "runpy.run_module('sd_tpu_torch.scripts.train', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'sd_tpu')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    meta = torch.load(tmp_path / "checkpoints" / "last.pt", weights_only=True)["meta"]
    assert meta["step"] == 2 and meta["seed"] == 23


# ------------------------------------------------------- the import guard


# regex: sd_tpu's tokenizer needs it; the card's machine does not have it
_FORBIDDEN = {"jax", "flax", "optax", "sd_tpu", "regex"}


def _imported_roots(path):
    tree = ast.parse(pathlib.Path(path).read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax_or_sd_tpu():
    files = sorted((_REPO / "sd_tpu_torch").rglob("*.py")) + [_REPO / "chip_smoke.py"]
    assert len(files) > 30
    for module in ("samplers/ancestral.py", "pipelines/img2img.py", "scripts/img2img.py",
                   "scripts/serve.py", "training/trainer.py", "utils/image.py",
                   "models/encoders.py", "models/vgg.py", "training/lpips.py",
                   "training/discriminator.py", "training/vae_gan.py", "scripts/train.py",
                   "utils/config.py", "scripts/inpaint.py", "scripts/sample_diffusion.py",
                   "pipelines/tiled.py", "pipelines/superres.py", "data/layout.py",
                   "ops/resize.py", "data/degradation.py", "data/lsun.py",
                   "data/imagenet.py", "data/native_loader.py", "models/encoder_unet.py",
                   "training/classifier.py", "pipelines/retrieval.py", "scripts/knn2img.py",
                   "scripts/train_searcher.py", "models/vae_extras.py", "utils/profiling.py",
                   "utils/tb_events.py", "utils/prefetch.py", "parallel/mesh.py",
                   "parallel/tp.py", "parallel/sharded_sampling.py", "core/draws.py",
                   "scripts/dryrun_multigpu.py", "scripts/convergence_run.py",
                   "scripts/int8_quality.py"):
        assert _REPO / "sd_tpu_torch" / module in files
    bad = {str(f.relative_to(_REPO)): sorted(set(_imported_roots(f)) & _FORBIDDEN)
           for f in files}
    assert not {f: roots for f, roots in bad.items() if roots}
