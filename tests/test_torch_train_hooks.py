"""The training loop's hooks in the port against sd_tpu's on the CPU, in
fp32: ``log_images`` on the tiny model with sd_tpu's draws made by its own
key splits (the arrays within 1e-4 of their scale, fp32 through the VAE and
UNet; a 12-step schedule, so that the port's ancestral denoise row is
short), the image helpers, the ``ImageLogger``'s cadence,
``save_monitored``'s top k, the SIGUSR1 save, the image logger and
validation leaving the trained weights bit for bit as they are without
them, and validation's EMA loss under bf16 autocast being the shadow's.
"""

import os
import signal

import numpy as np
import pytest
import torch

import jax

from sd_tpu.training import trainer as jtrainer
from sd_tpu.utils.image import segmentation_to_rgb as jax_segmentation_to_rgb
from sd_tpu.utils.image import text_to_image as jax_text_to_image
from sd_tpu_torch.scripts.train import build_trainer, parse_args
from sd_tpu_torch.training import trainer as port_trainer
from sd_tpu_torch.utils.checkpoint import save_monitored
from sd_tpu_torch.utils.config import build_latent_diffusion, tiny_sd_model_config
from sd_tpu_torch.utils.image import segmentation_to_rgb, text_to_image
from sd_tpu_torch.utils.testing import load_numpy_state_dict
from torch_parity import ldm_state_dict, tiny_jax_ldm, torch_threads

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


class _Jitted:
    """sd_tpu's LatentDiffusion with its model calls compiled whole (eager
    op-by-op dispatch of the VAE would cost seconds); the same functions."""

    def __init__(self, ldm):
        self._ldm = ldm
        for name in ("encode_to_latent", "decode_first_stage", "apply_model",
                     "get_learned_conditioning"):
            setattr(self, name, jax.jit(getattr(ldm, name)))

    def __getattr__(self, name):
        return getattr(self._ldm, name)


def test_log_images_matches_sd_tpu():
    cfg = tiny_sd_model_config()
    cfg["params"]["timesteps"] = 12
    jldm = tiny_jax_ldm(cfg, np.random.default_rng(0))
    ldm = load_numpy_state_dict(build_latent_diffusion(cfg, device="cpu"),
                                ldm_state_dict(cfg, jldm))
    rng = np.random.default_rng(4)
    batch = {"image": rng.uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32),
             "caption": rng.integers(0, 64, (3, 8)).astype(np.int32)}
    key = jax.random.PRNGKey(9)
    want = jtrainer.log_images(_Jitted(jldm), batch, key, n_row=2, sample_steps=4)
    # sd_tpu's draws: split(key, 4) gives the posterior's, the samples' and
    # the diffusion row's keys; the samples' x_T is one split of theirs
    _, k_enc, k_samp, k_diff = jax.random.split(key, 4)
    shape = (2, 16, 16, 4)
    draws = {"posterior": jax.random.normal(k_enc, shape),
             "sample": jax.random.normal(jax.random.split(k_samp)[1], shape),
             "diffusion": jax.random.normal(k_diff, shape)}
    got = port_trainer.log_images(ldm, batch, n_row=2, sample_steps=4, noise=draws)
    assert sorted(got) == sorted(want) == ["diffusion_row", "inputs", "reconstruction",
                                           "samples"]
    assert got["diffusion_row"].shape == (1, 6 * 32, 2 * 32, 3)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    # the denoise row (progressive_denoising, held against sd_tpu's in
    # test_torch_samplers.py): every T/6 = 2 steps of 12, decoded as a grid
    got = port_trainer.log_images(ldm, batch, torch.Generator().manual_seed(0), n_row=2,
                                  sample_steps=4, plot_denoise_rows=True)
    assert got["denoise_row"].shape == (1, 6 * 32, 2 * 32, 3)
    assert np.isfinite(got["denoise_row"]).all() and got["denoise_row"].std() > 0
    # string captions: drawn as images, and no samples
    captions = {"image": batch["image"], "caption": ["a red cube", "a blue ball", "x"]}
    got = port_trainer.log_images(ldm, captions, torch.Generator().manual_seed(0), n_row=2)
    assert sorted(got) == ["conditioning", "diffusion_row", "inputs", "reconstruction"]
    np.testing.assert_array_equal(got["conditioning"],
                                  jax_text_to_image((128, 128), captions["caption"][:2]))


def test_image_helpers_match_sd_tpu():
    caps = ["a painting of a virus monster playing guitar, " * 3, "", "ünïcødé ✓"]
    np.testing.assert_array_equal(text_to_image((96, 64), caps),
                                  jax_text_to_image((96, 64), caps))
    seg = np.eye(5, dtype=np.float32)[np.random.default_rng(0).integers(0, 5, (2, 8, 8))]
    np.testing.assert_array_equal(segmentation_to_rgb(seg, 3), jax_segmentation_to_rgb(seg, 3))


def test_image_logger_cadence_matches_sd_tpu(tmp_path):
    for every, first_n in ((750, True), (5, False), (3, True)):
        got = port_trainer.ImageLogger(str(tmp_path), every=every, log_first_n=first_n)
        want = jtrainer.ImageLogger(str(tmp_path), every=every, log_first_n=first_n)
        assert [got.should_log(s) for s in range(2001)] == [want.should_log(s)
                                                            for s in range(2001)]
    assert os.path.isdir(tmp_path / "images")


class _State:
    def __init__(self, step):
        self.step = step

    def state_dict(self):
        return {"step": self.step, "w": torch.full((2,), float(self.step))}


@pytest.mark.parametrize("mode", ["min", "max"])
def test_save_monitored_keeps_the_top_k(tmp_path, mode):
    tracked = []
    values = {1: 5.0, 2: 3.0, 3: 4.0, 4: 1.0, 5: 6.0, 6: 2.0}
    for step, value in values.items():
        path = save_monitored(str(tmp_path), _State(step), {"val/loss": value, "other": 0.0},
                              "val/loss", tracked, {"seed": 7}, mode=mode)
        assert path == str(tmp_path / f"step_{step}.pt")
    kept = [4, 6, 2] if mode == "min" else [5, 1, 3]
    assert [p for _, p in tracked] == [str(tmp_path / f"step_{s}.pt") for s in kept]
    assert sorted(os.listdir(tmp_path)) == sorted(f"step_{s}.pt" for s in kept)
    blob = torch.load(tmp_path / f"step_{kept[0]}.pt", weights_only=True)
    assert blob["meta"] == {"seed": 7, "metrics": {"val/loss": values[kept[0]], "other": 0.0},
                            "step": kept[0]}
    assert save_monitored(str(tmp_path), _State(9), {"other": 1.0}, "val/loss", tracked) is None
    assert save_monitored(str(tmp_path), _State(9), {"val/loss": 0.0}, None, tracked) is None
    assert len(tracked) == 3


def test_sigusr1_saves_last_at_the_end_of_the_step(tmp_path, monkeypatch):
    harness, state, data = build_trainer(parse_args(
        ["--tiny", "--device", "cpu", "--logdir", str(tmp_path), "--max_steps", "3",
         "--no_images"]))
    saved = []
    real_save = port_trainer.save_last

    def recording_save(ckpt_dir, state_, meta):
        saved.append(state_.step)
        return real_save(ckpt_dir, state_, meta)

    monkeypatch.setattr(port_trainer, "save_last", recording_save)
    step = harness.trainer_obj.train_step

    def step_then_signal(state_, batch, generator):
        aux = step(state_, batch, generator)
        if state_.step == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        return aux

    harness.trainer_obj.train_step = step_then_signal
    before = signal.getsignal(signal.SIGUSR1)
    harness.fit(state, data)
    assert saved == [1, 3]  # the signal's save at step 1, then the save on exit
    assert signal.getsignal(signal.SIGUSR1) == before


def test_image_logging_and_validation_leave_training_exact(tmp_path):
    """Two tiny steps with the image logger (at steps 1 and 2) and validation
    every step (monitored on val/loss_simple) give the UNet, AdamW and EMA
    of two steps without them, bit for bit."""
    runs = {}
    for name, flags in (("plain", ["--no_images"]), ("hooks", ["--val_every", "1"])):
        logdir = tmp_path / name
        harness, state, data = build_trainer(parse_args(
            ["--tiny", "--device", "cpu", "--logdir", str(logdir), "--max_steps", "2"] + flags))
        harness.monitor = "val/loss_simple"
        if harness.image_logger is not None:  # one image a grid: the cadence is what counts
            harness.image_logger = port_trainer.ImageLogger(str(logdir), max_images=1)
        harness.fit(state, data)
        runs[name] = (harness, state)
    (plain, a), (hooks, b) = runs["plain"], runs["hooks"]
    for (name, x), y in zip(a.unet.state_dict().items(), b.unet.state_dict().values()):
        assert torch.equal(x, y), name
    for k, v in a.ema.shadow.items():
        assert torch.equal(v, b.ema.shadow[k]), k
    for pa, pb in zip(a.unet.parameters(), b.unet.parameters()):
        assert torch.equal(a.optimizer.state[pa]["exp_avg_sq"], b.optimizer.state[pb]["exp_avg_sq"])
    assert b.unet.training and plain.image_logger is None
    images = sorted(os.listdir(tmp_path / "hooks" / "images"))
    assert images == sorted(f"train_{n}_step0000000{s}.png" for s in (1, 2)
                            for n in ("inputs", "reconstruction", "diffusion_row", "samples"))
    ckpts = sorted(os.listdir(tmp_path / "hooks" / "checkpoints"))
    assert ckpts == ["last.pt", "step_1.pt", "step_2.pt"]
    assert [p for _, p in hooks.monitored] != []
    meta = torch.load(tmp_path / "hooks" / "checkpoints" / "step_2.pt", weights_only=True)["meta"]
    assert set(meta["metrics"]) == {"val/loss_simple", "val/loss_simple_ema"}
    assert all(np.isfinite(v) for v in meta["metrics"].values())


def test_validation_ema_loss_is_the_shadow_loss_under_autocast(tmp_path):
    """``val/loss_simple_ema`` under bf16 autocast (the card's train step's
    setting, here on the CPU) equals the loss of the UNet holding the EMA
    shadow's weights, computed in an autocast context of its own: autocast's
    cached casts of the current weights must not reach the EMA pass."""
    harness, state, data = build_trainer(parse_args(
        ["--tiny", "--device", "cpu", "--logdir", str(tmp_path), "--max_steps", "1",
         "--no_images"]))
    trainer_obj = harness.trainer_obj
    trainer_obj.autocast = lambda: torch.autocast("cpu", dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    for s in state.ema.shadow.values():
        s.add_(0.05 * torch.randn(s.shape, generator=gen))
    metrics = harness.validate(state, data)
    batches = list(data.val_dataloader())[:port_trainer.VAL_BATCHES]
    unet = trainer_obj.unet
    current = {n: p.detach().clone() for n, p in unet.named_parameters()}

    def loss_with(weights):
        with torch.no_grad():
            for n, p in unet.named_parameters():
                p.copy_(weights[n])
            unet.eval()
            losses = [trainer_obj.loss_fn(b, harness._generator(
                state.step, port_trainer.VAL_STREAM + i))[0] for i, b in enumerate(batches)]
            unet.train()
        return float(np.mean(torch.stack(losses).float().numpy()))

    want_ema, want = loss_with(state.ema.shadow), loss_with(current)
    assert want_ema != want  # the shadow's loss is not the current weights'
    assert metrics == {"val/loss_simple": want, "val/loss_simple_ema": want_ema}
    for n, p in unet.named_parameters():
        assert torch.equal(p, current[n]), n
