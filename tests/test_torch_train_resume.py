"""The port's ``--base`` training CLI on the CPU: runs of
configs/sd_tpu/tiny-autoencoder-kl.yaml (the VAE-GAN, its discriminator
engaged from step 2 by a dotlist override) and of
configs/sd_tpu/convergence-shapes.yaml shrunk by a dotlist (with a trained
ClassEmbedder, a learned logvar table and scale_by_std), each resumed
exactly: 4 steps in one run equal 2 steps, a checkpoint, ``--resume <logdir>``
and 2 more, bit for bit in every weight, optimizer moment, the
discriminator's BatchNorm statistics, the logvars, the EMA shadow and the
calibrated scale_factor (which a resumed run takes from its checkpoint and
does not calibrate again). One run goes through a fresh interpreter, which
imports neither jax, flax nor sd_tpu. The step math against sd_tpu's is in
test_torch_first_stage.py and test_torch_train_config.py.
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from sd_tpu_torch.scripts.train import build_trainer, main, parse_args
from torch_parity import torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


_REPO = pathlib.Path(__file__).resolve().parents[1]
AE = str(_REPO / "configs/sd_tpu/tiny-autoencoder-kl.yaml")
SHAPES = str(_REPO / "configs/sd_tpu/convergence-shapes.yaml")
AE_DOTLIST = ["model.params.lossconfig.params.disc_start=2"]
SHAPES_DOTLIST = ["model.params.image_size=16", "data.params.batch_size=2",
                  "data.params.train.params.size=16", "data.params.train.params.length=6",
                  "model.params.cond_stage_trainable=true", "model.params.learn_logvar=true",
                  "model.params.scale_by_std=true", "model.params.loss_type=l1"]


def _run(base, logdir, steps, dotlist, resume=None, name="run"):
    argv = ["--base", base, "-t", "--device", "cpu", "--max_steps", str(steps), "--log_every",
            "1", "--no_images", "-n", name, "--logdir", str(logdir)] + dotlist
    if resume:
        argv = ["-t", "--device", "cpu", "--max_steps", str(steps), "--log_every", "1",
                "--no_images", "--resume", str(resume)]
    main(argv)
    if resume:
        return pathlib.Path(resume)
    (run,) = [p for p in pathlib.Path(logdir).iterdir() if p.name.endswith(f"_{name}")]
    return run


def _last(run):
    return torch.load(run / "checkpoints" / "last.pt", weights_only=True)


def _assert_equal(a, b, path="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_first_stage_cli_resumes_exactly(tmp_path):
    # one torch thread there too, as here, for a bit-for-bit comparison
    code = ("import runpy, sys, torch\n"
            "torch.set_num_threads(1)\n"
            f"sys.argv = ['train', '--base', {AE!r}, '-t', '--device', 'cpu', '--max_steps', '4',"
            f" '-n', 'whole', '--logdir', {str(tmp_path / 'whole')!r}, {AE_DOTLIST[0]!r}]\n"
            "runpy.run_module('sd_tpu_torch.scripts.train', run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', "
            "'sd_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (whole,) = (tmp_path / "whole").iterdir()
    split = _run(AE, tmp_path / "split", 2, AE_DOTLIST)
    assert _last(split)["state"]["step"] == 2
    _run(AE, None, 4, [], resume=split)
    a, b = _last(whole), _last(split)
    assert a["meta"]["step"] == b["meta"]["step"] == 4
    assert set(a["state"]) == {"step", "ae", "ae_opt", "disc", "disc_opt", "logvar"}
    _assert_equal(a["state"], b["state"])
    # the discriminator trained (disc_start 2) and its statistics moved
    sd = a["state"]["disc"]
    assert sd["main.3.num_batches_tracked"] == 8
    assert not torch.equal(sd["main.3.running_var"], torch.ones_like(sd["main.3.running_var"]))
    assert a["state"]["logvar"] != 0


def test_ldm_cli_with_trained_cond_stage_and_scale_by_std_resumes_exactly(tmp_path):
    whole = _run(SHAPES, tmp_path / "whole", 4, SHAPES_DOTLIST)
    split = _run(SHAPES, tmp_path / "split", 2, SHAPES_DOTLIST)
    _run(SHAPES, None, 4, [], resume=split)
    a, b = _last(whole), _last(split)
    assert a["meta"]["step"] == b["meta"]["step"] == 4
    _assert_equal(a["state"], b["state"])
    assert a["state"]["cond_stage"] is not None and a["state"]["logvar"] is not None
    assert "cond_stage_model.embedding.weight" in a["state"]["ema"]["shadow"]
    # the calibrated scale: one over the std of the first batch's images
    # (an identity first stage), carried across the resume
    harness, _, data = build_trainer(parse_args(
        ["--base", SHAPES, "--device", "cpu", "--logdir", str(tmp_path / "probe")]
        + SHAPES_DOTLIST))
    want = 1.0 / float(torch.from_numpy(data.train_dataloader().batch(0)["image"]).std())
    np.testing.assert_allclose(a["meta"]["scale_factor"], want, rtol=1e-6)
    assert b["meta"]["scale_factor"] == a["meta"]["scale_factor"]
    assert harness.trainer_obj.ldm.scale_factor == 1.0  # not calibrated before fit
