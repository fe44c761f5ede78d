"""First-stage data parallelism at two ranks on the CPU (gloo), in one launch
of the training CLI under ``torch.distributed.run`` (run A: 2 steps of the
tiny KL VAE-GAN) and one of ``tests/torch_dist_worker.py first_stage`` (a
``FileStore`` under the test's directory; the ranks import the port alone),
which continues run A, among other checks.

The reference of N ranks is one process that splits each batch into the
rows ``s::N`` and takes a rank's step on each (``VAEGANTrainer(shards=N)``):
each shard keeps its own adaptive weight and its own BatchNorm batch
statistics, as each rank does under the reference's DDP, so two ranks at
batch 2 are that reference at batch 4, not a plain step at batch 4. The
tiny KL config (``configs/sd_tpu/tiny-autoencoder-kl.yaml``) and a tiny VQ
model (``dryrun_multigpu.TINY_VQ_CONFIG``) train 2 steps from ``disc_start``
0 on 24² images (the PatchGAN's least). Tolerances, each with its reason (fp32
on the CPU; the ranks' gradients
are summed by gloo where the reference adds the shards' in turn):

- both Adams' first moments within ``MOMENT_TOL`` (1e-3) of their scale, the
  weights within 5e-5 (``sd_tpu``'s dryrun bound) wherever the gradient is
  not rounding noise (``dryrun_multigpu.compare_training`` at Adam's beta2
  of 0.9); the logvar within 5e-5;
- the discriminator's running statistics (rank 0's: DDP broadcasts them
  before each forward) within ``STATS_TOL`` (1e-5, relative L2) of the
  reference's shard 0;
- the ranks' logvars, the resize draws and rank 0's statistics in its
  checkpoint: equal.
"""

import glob
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from sd_tpu_torch.scripts.dryrun_multigpu import (CPU_TOL, FIRST_STAGE_BETA2, MOMENT_TOL,
                                                  STATS_TOL, compare_training)
from torch_dist_worker import FIRST_STAGE_ARGS, FIRST_STAGE_KL, first_stage_fit, vae_gan_run
from torch_parity import torch_threads

REPO = pathlib.Path(__file__).resolve().parents[1]
# the launched processes run one torch thread each and find the repository
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _last(run_dir):
    return torch.load(os.path.join(run_dir, "checkpoints", "last.pt"), weights_only=True)["state"]


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    """The one-process reference of two ranks (2 steps at batch 4, ``w1``),
    run A (the CLI under ``torch.distributed.run``, 2 steps at two ranks; its
    checkpoint kept as ``a_step2.pt``), then both ranks of the worker's
    first-stage checks. Returns the directory, the worker's numbers, each
    rank's dry-run leg and run A's output."""
    root = tmp_path_factory.mktemp("first_stage_dist")
    first_stage_fit(["--base", FIRST_STAGE_KL, "--max_steps", "2", "--batch_size", "4", "-l",
                     str(root / "w1"), "-n", "w1"], shards=2)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "sd_tpu_torch.scripts.train", "--base", FIRST_STAGE_KL, "--backend", "gloo",
         "--max_steps", "2", "-l", str(root / "a"), "-n", "a",
         *[a for a in FIRST_STAGE_ARGS if a != "--no_images"]],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    (run_a,) = glob.glob(str(root / "a" / "*_a"))
    shutil.copy(os.path.join(run_a, "checkpoints", "last.pt"), root / "a_step2.pt")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests/torch_dist_worker.py"),
                               str(root), "first_stage"], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env={**ENV, "RANK": str(r), "LOCAL_RANK": str(r),
                                   "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"})
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    legs = [json.load(open(root / f"first_stage_rank{r}.json")) for r in range(2)]
    return root, json.load(open(root / "first_stage.json")), legs, proc.stdout


def test_vq_at_two_ranks_matches_the_reference_of_two(worker):
    """The dry run's first_stage leg on the tiny VQ model: DDP + ZeRO-1 over
    both Adams against the reference, each rank at most its share of the
    moments plus the largest parameter."""
    legs = worker[2]
    leg = legs[0]["vq"]
    assert leg["ok"] and leg["moment_err"] < MOMENT_TOL and leg["max_abs"] < CPU_TOL, leg
    assert leg["stats_rel_l2"] < STATS_TOL and leg["logvar_gap"] < CPU_TOL, leg
    # shard 0's logs are rank 0's (rows 0::2), within fp32 rounding
    assert leg["loss"] == pytest.approx(leg["reference_loss"], rel=1e-5)
    assert all(d > 0 for d in leg["d_weight"]) and all(d > 0 for d in leg["disc_loss"])
    for part in ("ae", "disc"):
        zero = [legs[r]["vq"]["zero"][part] for r in range(2)]
        assert all(z["owned_bytes"] <= z["share_bytes"] + z["largest_bytes"] for z in zero)
        assert sum(z["owned_bytes"] for z in zero) == 2 * zero[0]["share_bytes"]
    assert "logvar" not in leg


def test_kl_at_two_ranks_matches_the_reference_of_two(worker):
    """Run A's first 2 steps of the tiny KL model at two ranks through the
    CLI (DDP + ZeRO-1) against the test's reference."""
    root = worker[0]
    (w1,) = glob.glob(str(root / "w1" / "*_w1"))
    got = torch.load(root / "a_step2.pt", weights_only=True)["state"]
    want = _last(w1)
    res = compare_training(vae_gan_run(got), vae_gan_run(want), on_cpu=True,
                           beta2=FIRST_STAGE_BETA2)
    assert res["ok"], res
    assert abs(float(got["logvar"] - want["logvar"])) < CPU_TOL


def test_every_rank_holds_the_same_logvar(worker):
    logvars = worker[1]["logvars"]
    assert len(logvars) == 2 and logvars[0] == logvars[1]


def test_the_discriminator_keeps_rank0s_running_statistics(worker):
    out = worker[1]
    assert out["stats_saved_are_rank0s"]
    # rank 1 moved its own copy by its rows after rank 0's broadcast: the
    # check could tell them apart
    assert out["stats_rank1_differ"]


def test_every_rank_draws_the_same_resize(worker):
    sizes = worker[1]["resize_sizes"]
    assert sizes[0] == sizes[1] and len(sizes[0]) == 10
    assert sizes[0][:5] == [48] * 5 and len(set(sizes[0])) > 1


def test_world1_checkpoint_resumes_at_world2(worker):
    res = worker[1]["from_world1"]
    assert res["ok"] and res["step"] == 4 and res["logvar_gap"] < CPU_TOL, res


def test_world2_checkpoint_resumes_at_world1(worker, tmp_path):
    """Run A's step-2 checkpoint continued by the reference of two ranks in
    one process to the weights of A's 4 steps at two ranks."""
    root = worker[0]
    (run_a,) = glob.glob(str(root / "a" / "*_a"))
    resumed = tmp_path / "a_at_1"
    shutil.copytree(run_a, resumed)
    shutil.copy(root / "a_step2.pt", resumed / "checkpoints" / "last.pt")
    _, state = first_stage_fit(["--resume", str(resumed), "--max_steps", "4", "--batch_size",
                                "4"], resume=True, shards=2)
    assert not hasattr(state.ae_opt, "consolidate_state_dict")
    got, want = _last(resumed), _last(run_a)
    assert got["step"] == want["step"] == 4
    res = compare_training(vae_gan_run(got), vae_gan_run(want), on_cpu=True,
                           beta2=FIRST_STAGE_BETA2)
    assert res["ok"], res


def test_first_stage_cli_under_torchrun(worker):
    """Run A: rank 0 alone prints the LR line (2 devices) and writes the run
    (one directory, its config, one image grid a name and logged step) and a
    checkpoint in the one-process layout."""
    root, out = worker[0], worker[3]
    lr_lines = [line for line in out.splitlines() if line.startswith("Setting learning rate")]
    assert len(lr_lines) == 1 and "= 2 (devices) * 2 (batchsize)" in lr_lines[0], out
    (run,) = glob.glob(str(root / "a" / "*"))
    assert os.path.isfile(os.path.join(run, "configs", "project.yaml"))
    assert sorted(os.listdir(os.path.join(run, "images"))) == sorted(
        f"train_{name}_step{step:08}.png" for name in ("inputs", "reconstructions", "samples")
        for step in (1, 2))
    # both optimizers whole: every parameter's state, in the parameters' order
    state = torch.load(root / "a_step2.pt", weights_only=True)["state"]
    assert set(state) == {"step", "ae", "ae_opt", "disc", "disc_opt", "logvar"}
    assert state["step"] == 2
    n_disc = sum(1 for k in state["disc"] if "running" not in k and "num_batches" not in k)
    for opt, n in (("ae_opt", len(state["ae"])), ("disc_opt", n_disc)):
        assert sorted(state[opt]["state"]) == list(range(n))
        assert [i for g in state[opt]["param_groups"] for i in g["params"]] == list(range(n))
