"""The convergence run, the int8 quality gate and training's --ckpt warm
start of the port (sd_tpu_torch/scripts/convergence_run.py, int8_quality.py
and train.py --ckpt) on the CPU, against tools/convergence_run.py,
tools/int8_quality.py and sd_tpu.

Tolerances, each with its reason:

- smooth, the loss summary and color_report: exact (the same arithmetic on
  the same numbers);
- sample_set on the 16² probe against sd_tpu's p_sample_loop(clip_denoised=
  True), fp32, the same x_T and per-step noise, 20 timesteps: max |diff|
  <= 1e-5 (the UNet's fp32 sums in other orders, carried through the chain);
- the loss falls: the tail's mean below 0.75 of the head's, as
  tests/test_convergence.py asks of sd_tpu;
- the kill and resume: exactly 0 in the weights, the EMA shadow and the
  optimizer state;
- --ckpt: the weights and the EMA shadow equal to the file's, exactly (a
  copy); the first step's loss at sd_tpu's t and noise within rtol 1e-5 of
  sd_tpu's (fp32, as tests/test_torch_train_config.py compares the step).
"""

import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sd_tpu.samplers.ancestral import p_sample_loop as jax_p_sample_loop
from sd_tpu.training.diffusion_loss import LDMTrainer as JaxLDMTrainer
from sd_tpu.utils import config as jconfig
from sd_tpu.utils.port import load_torch_state_dict as jax_load_state_dict
from sd_tpu_torch.data.synthetic import ColoredShapes
from sd_tpu_torch.models.unet import UNetConfig
from sd_tpu_torch.scripts import convergence_run, int8_quality
from sd_tpu_torch.scripts.train import build_trainer, parse_args
from sd_tpu_torch.utils import config, convert
from sd_tpu_torch.utils.profiling import MetricsWriter
from torch_parity import nchw, random_params, torch_threads

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


_REPO = pathlib.Path(__file__).resolve().parents[1]
_PROBE = str(_REPO / "configs/sd_tpu/convergence-shapes.yaml")
# the probe at 16², batch 2
PROBE_16 = ["model.params.image_size=16", "data.params.batch_size=2",
            "data.params.train.params.size=16", "data.params.train.params.length=8",
            "data.params.validation.params.size=16", "data.params.validation.params.length=4"]


def _tool(name):
    """tools/<name>.py, loaded by path (tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location(f"tool_{name}", _REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _probe_config(dotlist):
    return jconfig.apply_dotlist(jconfig.load_yaml(_PROBE), dotlist)


def _probe_state_dict(cfg, seed=5) -> dict:
    """A reference-layout state dict of the probe (the UNet and the
    ClassEmbedder; the identity first stage has none) from sd_tpu's
    parameter shapes, numpy from ``seed``."""
    jldm = jconfig.build_latent_diffusion(cfg["model"], init_params=False)
    unet_p = cfg["model"]["params"]["unet_config"]["params"]
    hw = cfg["model"]["params"]["image_size"]
    rng = np.random.default_rng(seed)
    unet = random_params(jldm.unet, rng, jnp.zeros((1, hw, hw, 3)), jnp.zeros((1,), jnp.int32),
                         jnp.zeros((1, 1, unet_p["context_dim"])))
    cond = random_params(jldm.cond_stage_model, rng, jnp.zeros((1,), jnp.int32))
    parts = {"model.diffusion_model.": convert.unet_state_dict(unet, UNetConfig.from_dict(unet_p)),
             "cond_stage_model.": convert.class_embedder_state_dict(cond)}
    return {p + k: torch.from_numpy(np.ascontiguousarray(v))
            for p, sd in parts.items() for k, v in sd.items()}


@pytest.fixture
def probe_ckpt(tmp_path):
    """A synthetic reference-layout .ckpt of the 16² probe."""
    sd = _probe_state_dict(_probe_config(PROBE_16))
    path = str(tmp_path / "probe.ckpt")
    torch.save({"state_dict": sd}, path)
    return path, sd


# ------------------------------------------------ the tools' own arithmetic


def test_smooth_and_loss_summary_equal_the_tool():
    tool = _tool("convergence_run")
    losses = list(np.random.default_rng(3).uniform(0.05, 1.0, 90).cumsum()[::-1] / 40)
    assert convergence_run.smooth(losses) == tool.smooth(losses)
    assert convergence_run.smooth(losses, w=3) == tool.smooth(losses, w=3)
    # tools/convergence_run.py's summary, as its main() computes it
    sm = tool.smooth(losses, w=10)
    head, tail = sm[min(3, len(sm) - 1)], sm[-1]
    viol = sum(1 for i in range(4, len(sm)) if sm[i] > sm[i - 1] * 1.02)
    assert convergence_run.loss_summary(losses) == {
        "loss_first_smoothed": round(head, 5), "loss_final_smoothed": round(tail, 5),
        "loss_reduction_pct": round(100 * (1 - tail / head), 2),
        "smoothed_monotonic_violations_pct": round(100 * viol / max(len(sm) - 4, 1), 2)}


def test_color_report_equals_the_tool():
    tool = _tool("int8_quality")
    rng = np.random.default_rng(4)
    imgs = rng.uniform(-1, 1, (16, 8, 8, 3)).astype(np.float32)
    imgs[:4] = -0.95  # no foreground
    imgs[4:8, 2:6, 2:6] = ColoredShapes._COLORS[1]
    labels = np.repeat(np.arange(8), 2)
    assert int8_quality.color_report(imgs, labels) == tool.color_report(imgs, labels)


# ------------------------------------------------------------- sample_set


def test_sample_set_matches_sd_tpu_p_sample_loop(tmp_path):
    cfg = _probe_config(PROBE_16 + ["model.params.timesteps=20"])
    sd = _probe_state_dict(cfg)
    torch.save({"state_dict": sd}, tmp_path / "probe.ckpt")
    ldm = config.build_latent_diffusion(cfg["model"], device="cpu", state_dict=sd)
    jldm = jconfig.build_latent_diffusion(
        cfg["model"], state_dict=jax_load_state_dict(str(tmp_path / "probe.ckpt")),
        init_params=False)
    # sd_tpu's build_latent_diffusion ports no ClassEmbedder from a state dict
    # (ROADMAP.md): its table from the same file
    jldm = dataclasses.replace(jldm, cond_stage_params={"embedding": {"embedding": jnp.asarray(
        sd["cond_stage_model.embedding.weight"].numpy())}})
    labels = np.arange(4)
    key = jax.random.PRNGKey(12)
    shape = (4, 16, 16, 3)
    want, _ = jax_p_sample_loop(jldm.apply_model, jldm.schedule, shape,
                                cond=jldm.get_learned_conditioning(jnp.asarray(labels)), rng=key,
                                clip_denoised=True)
    # sd_tpu's draws: x_T split off the key first, then a four-way split a step
    key, k_init = jax.random.split(key)
    noise = []
    for _ in range(20):
        key, k_noise, _, _ = jax.random.split(key, 4)
        noise.append(nchw(jax.random.normal(k_noise, shape)))
    x_T = nchw(jax.random.normal(k_init, shape))
    with torch.no_grad():
        cond = ldm.get_learned_conditioning(torch.as_tensor(labels))
    got = int8_quality.sample_set(ldm, cond, x_T.shape, x_T=x_T, noise=noise)
    want = np.asarray(jldm.decode_first_stage(want))
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------------ training converges


def test_loss_decreases_on_colored_shapes(tmp_path):
    """The port of tests/test_convergence.py's test: 150 steps at 16², the
    probe's width, batch 8 of 64 images, LR 1e-3, no EMA."""
    opt = parse_args(["--base", _PROBE, "-t", "--device", "cpu", "--logdir", str(tmp_path),
                      "--no_images", "--max_steps", "150", "--log_every", "5",
                      "--ckpt_every", str(10**6), "-s", "5",
                      "model.params.image_size=16", "model.params.use_ema=false",
                      "data.params.batch_size=8", "data.params.train.params.size=16",
                      "data.params.train.params.length=64", "data.params.train.params.radius=4",
                      "data.params.train.params.jitter=2"])
    harness, state, data = build_trainer(opt)
    assert harness.trainer_obj.base_lr == pytest.approx(1e-3)
    assert isinstance(harness.metrics_writer, MetricsWriter)
    harness.fit(state, data)
    rows = [json.loads(line) for line in open(pathlib.Path(harness.logdir) / "metrics.jsonl")]
    losses = [r["train/loss"] for r in rows if "train/loss" in r]
    assert len(losses) == 30 and np.isfinite(losses).all()
    head, tail = float(np.mean(losses[:6])), float(np.mean(losses[-6:]))
    assert tail < 0.75 * head, f"loss did not decrease: head {head:.4f} -> tail {tail:.4f}"


# ---------------------------------------------------- kill and exact resume


# the probe cut to 8² images, one level, batch 2
TINY = ["model.params.image_size=8", "data.params.train.params.size=8",
        "data.params.batch_size=2", "data.params.train.params.radius=3",
        "data.params.train.params.jitter=1", "model.params.unet_config.params.channel_mult=[1]",
        "model.params.unet_config.params.attention_resolutions=[1]"]


def test_convergence_run_kills_and_resumes_exactly(tmp_path, monkeypatch):
    """SIGUSR1 at step 50 of 100 (a logged step: the CLI logs every 25),
    SIGKILL, resume: the final states equal run A's."""
    monkeypatch.setattr(convergence_run, "POLL_S", 0.05)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "out"
    rc = convergence_run.main(["--steps", "100", "--device", "cpu", "--out",
                               str(out), "--workdir", str(tmp_path / "runs")] + TINY)
    report = json.loads((out / "resume_report.json").read_text())
    assert rc == (0 if report["loss_reduction_pct"] > 50 else 1)
    assert 50 <= report["melk_step"] < 100
    assert report["resume_max_abs_diff"] == {"params": 0.0, "ema": 0.0, "opt_state": 0.0}
    assert report["runB_losses_match_runA"]
    assert report["launches"] == {"runA": None, "runB_resumed": None}
    assert (out / "REPORT.md").is_file() and (out / "metrics_runA.jsonl").is_file()


@pytest.mark.parametrize("flagship", [False, True], ids=["probe", "flagship"])
def test_int8_quality_refuses_the_cpu(flagship):
    with pytest.raises(SystemExit, match="int8 mode runs only for bf16 tensors on a CUDA"):
        int8_quality.main(["--device", "cpu"] + (["--flagship"] if flagship else []))


# ------------------------------------------------------------ --ckpt


def _ckpt_opt(tmp_path, ckpt, *extra):
    return parse_args(["--base", _PROBE, "-t", "--device", "cpu", "--logdir", str(tmp_path),
                       "--no_images", "--ckpt", ckpt] + PROBE_16 + list(extra))


def test_ckpt_warm_starts_the_weights_and_the_ema(tmp_path, probe_ckpt):
    path, sd = probe_ckpt
    harness, state, _ = build_trainer(_ckpt_opt(tmp_path, path))
    ldm = harness.trainer_obj.ldm
    assert set(ldm.state_dict()) == set(sd)
    for name, value in ldm.state_dict().items():
        assert torch.equal(value, sd[name]), name
    shadow = state.ema.state_dict()["shadow"]
    unet = ldm.model.diffusion_model.state_dict()
    assert set(shadow) == set(dict(ldm.model.diffusion_model.named_parameters()))
    for name, value in shadow.items():
        assert torch.equal(value, unet[name]), name


def test_ckpt_first_step_loss_matches_sd_tpu(tmp_path, probe_ckpt):
    path, _ = probe_ckpt
    harness, _, data = build_trainer(_ckpt_opt(tmp_path, path))
    trainer = harness.trainer_obj
    jldm = jconfig.build_latent_diffusion(_probe_config(PROBE_16)["model"],
                                          state_dict=jax_load_state_dict(path),
                                          init_params=False)
    # sd_tpu's build_latent_diffusion leaves a ClassEmbedder unported (ROADMAP.md, the
    # reference's faults): main.py --ckpt on the probe has no class table
    assert jldm.cond_stage_params is None
    table = jax_load_state_dict(path)["cond_stage_model.embedding.weight"]
    jldm = dataclasses.replace(jldm, cond_stage_params={"embedding": {"embedding":
                                                                      jnp.asarray(table)}})
    jtrainer = JaxLDMTrainer(ldm=jldm, optimizer=optax.adamw(1e-3))
    params = jtrainer.init_state().params
    batch = data.train_dataloader().batch(0)
    key = jax.random.PRNGKey(7)
    want, _ = jax.jit(jtrainer.loss_fn)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                        key)
    # sd_tpu's draws: the identity first stage draws nothing from k_enc
    _, k_t, k_noise = jax.random.split(key, 3)
    t = np.asarray(jax.random.randint(k_t, (2,), 0, 1000))
    noise = np.asarray(jax.random.normal(k_noise, batch["image"].shape))
    z, cond = trainer.latents_and_cond(batch)
    loss, _ = trainer.loss_at(z, cond, torch.from_numpy(t.copy()), nchw(noise))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)


def test_ckpt_with_resume_keeps_the_runs_weights(tmp_path, probe_ckpt):
    """A warm-started run, one step, resumed with --ckpt and without: the
    run's weights win; the frozen ClassEmbedder is the file's each time, and
    in a sampler's build of the run (its config records the file)."""
    path, sd = probe_ckpt
    harness, state, data = build_trainer(_ckpt_opt(tmp_path, path, "--max_steps", "1"))
    harness.fit(state, data)
    run = harness.logdir
    saved = torch.load(pathlib.Path(run) / "checkpoints" / "last.pt",
                       weights_only=True)["state"]["unet"]
    table = sd["cond_stage_model.embedding.weight"]
    key = "input_blocks.0.0.weight"
    assert not torch.equal(saved[key], sd["model.diffusion_model." + key])
    for extra in (["--ckpt", path], []):
        harness2, state2, data2 = build_trainer(parse_args(
            ["-r", run, "-t", "--device", "cpu", "--no_images", "--max_steps", "1"] + extra))
        ldm = harness2.trainer_obj.ldm
        assert torch.equal(ldm.model.diffusion_model.state_dict()[key],
                           sd["model.diffusion_model." + key])
        harness2.fit(state2, data2, resume=True)
        assert state2.step == 1
        for name, value in ldm.model.diffusion_model.state_dict().items():
            assert torch.equal(value, saved[name]), name
        assert torch.equal(ldm.cond_stage_model.embedding.weight, table)
    sampler, _ = config.build_latent_diffusion_from_run(run, device="cpu", use_ema=False)
    assert torch.equal(sampler.cond_stage_model.embedding.weight, table)
    assert torch.equal(sampler.model.diffusion_model.state_dict()[key], saved[key])


def test_ckpt_refuses_a_first_stage_config(tmp_path, probe_ckpt):
    path, _ = probe_ckpt
    opt = parse_args(["--base", str(_REPO / "configs/sd_tpu/tiny-autoencoder-kl.yaml"), "-t",
                      "--device", "cpu", "--logdir", str(tmp_path), "--ckpt", path])
    with pytest.raises(SystemExit, match="first-stage model"):
        build_trainer(opt)
