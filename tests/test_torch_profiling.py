"""The port's training metrics and profiling utilities against sd_tpu's, on
the CPU: ``count_params``, ``unet_flops`` (the same integer as sd_tpu's for
SD v1 and the 768² RDM), ``StepTimer``, ``MetricsWriter``'s rows and its
TensorBoard event file (bytes equal to sd_tpu's ``TensorBoardWriter`` for
the same scalars and wall time), ``parallel_data_prefetch``, ``trace`` and
``annotate``, and the port's trainer writing ``metrics.jsonl`` and the
events of a ``--base`` run."""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sd_tpu.models import vae_extras as jx
from sd_tpu.models.unet import UNetConfig as JaxUNetConfig
from sd_tpu.utils import prefetch as jax_prefetch
from sd_tpu.utils import profiling as jax_profiling
from sd_tpu.utils import tb_events as jax_tb
from sd_tpu_torch.models import vae_extras as px
from sd_tpu_torch.models.unet import UNetConfig
from sd_tpu_torch.utils import convert, profiling, tb_events
from sd_tpu_torch.utils.config import SD_V1_MODEL_CONFIG, load_yaml
from sd_tpu_torch.utils.prefetch import parallel_data_prefetch
from torch_parity import random_params, torch_threads

RDM_CONFIG = "sd_tpu_torch/configs/retrieval-augmented-diffusion-768x768.yaml"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def test_count_params():
    """A module's count equals sd_tpu's count of the same parameters (its
    tree), and a mapping of arrays counts the same."""
    rng = np.random.default_rng(0)
    jmod = jx.SimpleDecoder(in_channels=32, out_channels=3)
    params = random_params(jmod, rng, jnp.zeros((1, 4, 4, 32)))
    want = jax_profiling.count_params(params, verbose=False)
    module = px.SimpleDecoder(32, 3)
    assert profiling.count_params(module, verbose=False) == want
    sd = convert.simple_decoder_state_dict(params)
    assert profiling.count_params(sd, verbose=False) == want


@pytest.mark.parametrize("name,hw", [("sd_v1", 64), ("rdm", 48)])
def test_unet_flops_equals_sd_tpus(name, hw):
    unet = (SD_V1_MODEL_CONFIG if name == "sd_v1"
            else load_yaml(os.path.join(ROOT, RDM_CONFIG))["model"])["params"]["unet_config"]
    p = unet["params"]
    for batch in (1, 2):
        got = profiling.unet_flops(UNetConfig.from_dict(p), hw, batch)
        assert got == jax_profiling.unet_flops(JaxUNetConfig.from_dict(p), hw, batch)
        assert got > 0


def test_step_timer():
    timer = profiling.StepTimer(window=3)
    assert timer.step() is None and timer.step() is None
    out = timer.step()
    assert set(out) == {"steps_per_sec", "sec_per_step"}
    assert out["steps_per_sec"] > 0 and out["sec_per_step"] == pytest.approx(
        1.0 / out["steps_per_sec"])
    assert timer.step() is None


def test_metrics_writer_rows_and_event_bytes(tmp_path, monkeypatch):
    """Scalars of every kind in one JSON line (a vector dropped); the
    TensorBoard tee byte for byte sd_tpu's writer's at the same wall time."""
    monkeypatch.setattr(tb_events.time, "time", lambda: 1700000000.25)
    writer = profiling.MetricsWriter(str(tmp_path / "port"))
    metrics = {"train/loss": torch.tensor(0.5), "lr": np.float32(1e-4), "n": 3,
               "vector": np.zeros(2)}
    writer.write(7, metrics)
    writer.write(8, {"val/loss_simple": 0.25}, split="val")
    writer.close()
    rows = [json.loads(line) for line in open(tmp_path / "port" / "metrics.jsonl")]
    assert [(r["step"], r["split"]) for r in rows] == [(7, "train"), (8, "val")]
    assert rows[0]["train/loss"] == 0.5 and rows[0]["n"] == 3.0 and "vector" not in rows[0]
    assert rows[0]["lr"] == pytest.approx(1e-4) and rows[1]["val/loss_simple"] == 0.25

    ref = jax_tb.TensorBoardWriter(str(tmp_path / "ref"))
    ref.write(7, {"train/loss": 0.5, "lr": float(np.float32(1e-4)), "n": 3.0})
    ref.write(8, {"val/loss_simple": 0.25})
    ref.close()
    (got,), (want,) = (glob.glob(str(tmp_path / d / "**" / "events.out.tfevents.*"),
                                 recursive=True) for d in ("port", "ref"))
    assert os.path.basename(got) == os.path.basename(want)
    assert open(got, "rb").read() == open(want, "rb").read()


def test_wandb_writer_needs_wandb():
    """Without the wandb package the sink refuses at construction."""
    if importlib.util.find_spec("wandb") is None:
        with pytest.raises(ImportError):
            profiling.WandbWriter()


def _square(chunk):
    return [x * x for x in chunk] if isinstance(chunk, list) else chunk ** 2


@pytest.mark.parametrize("kind", ["ndarray", "list", "dict"])
def test_parallel_data_prefetch(kind):
    data = {"ndarray": np.arange(10.0), "list": list(range(7)),
            "dict": {f"k{i}": i for i in range(5)}}[kind]
    target = "ndarray" if kind == "ndarray" else "list"
    got = parallel_data_prefetch(_square, data, n_proc=3, target_data_type=target,
                                 cpu_intensive=False)
    want = jax_prefetch.parallel_data_prefetch(_square, data, n_proc=3,
                                               target_data_type=target, cpu_intensive=False)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    with pytest.raises(ValueError):
        parallel_data_prefetch(_square, np.arange(4), target_data_type="list")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("unet_step"):
            torch.ones(8).sum()
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any(e.get("name") == "unet_step" for e in events)


def test_base_run_writes_metrics(tmp_path):
    """A tiny --base LDM run (ClassEmbedder over an IdentityFirstStage)
    writes each logged step and its validation to metrics.jsonl and to
    TensorBoard events."""
    from sd_tpu_torch.scripts import train

    train.main(["--base", os.path.join(ROOT, "configs/sd_tpu/convergence-shapes.yaml"), "-t",
                "--device", "cpu", "--max_steps", "2", "--log_every", "1", "--val_every", "2",
                "--no_images", "-l", str(tmp_path), "data.params.batch_size=2",
                "model.params.image_size=16", "data.params.train.params.size=16",
                "data.params.validation.params.size=16",
                "data.params.validation.params.length=2"])
    (run,) = glob.glob(str(tmp_path / "*_convergence-shapes"))
    rows = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 2]
    assert all(np.isfinite(r["train/loss"]) and r["train/it_per_sec"] > 0 for r in rows[:2])
    assert "val/loss_simple" in rows[2] and np.isfinite(rows[2]["val/loss_simple"])
    assert glob.glob(os.path.join(run, "tb", "events.out.tfevents.*"))
