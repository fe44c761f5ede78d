"""The port's parallelism at two ranks on the CPU (gloo), in two launches
of two processes that import the port alone:

1. ``tests/torch_dist_worker.py`` (a ``FileStore`` under ``tmp_path``):
   ``sharded_sample`` (DDIM at eta 0 and PLMS with guidance, on
   test_sharded_sampling.py's toy model) against ``sd_tpu``'s
   ``sharded_sample`` on its 2-device mesh from the same x_T, within 1e-5
   (fp32; sd_tpu's own sharded test's bound); DDIM at eta 1 from one
   generator equal to one process's run (its noise is the global batch's);
   ``tiled_apply(mesh=)`` at 49 patches (2 does not divide them) against
   ``sd_tpu``'s, within 1e-5; a world-2 training run resumed at world 2
   equal bit for bit to an uninterrupted one, its step-2 checkpoint
   (ZeRO-1's shards consolidated) continued at world 1 and twice the batch
   to the same weights as world 2, and a world-1 checkpoint at twice the
   batch continued at world 2 to them (``dryrun_multigpu.compare_training``:
   AdamW's first moments within 1e-3 of their scale, the weights and the EMA
   within 5e-5 where the gradient is not rounding noise); a SIGUSR1 to
   one rank saving on both at the end of that step;
   then ``scripts/dryrun_multigpu.py``'s legs in the same processes: DDP with
   ZeRO-1 (moments and EMA partitioned) with 2 accumulated micro-batches
   and the EMA against one process by ``compare_training`` (the weights
   within sd_tpu's 5e-5), each rank's moments within its share plus the
   largest parameter; HSDP (leg 3) on a (1, 2) mesh against one process
   likewise; the pipeline with a mesh against one process, max uint8
   difference <= 1; the tensor-parallel UNet's output and gradients
   against the replicated UNet within sd_tpu's 2e-5, one all-reduce a
   row-parallel boundary;
2. the training CLI under ``torch.distributed.run`` (a tiny ``--base`` run,
   which writes ``metrics.jsonl`` as ``main.py``'s do): rank 0 alone writes
   the run (one run directory, one TensorBoard writer, the metrics rows once)
   and the LR line names 2 devices.
"""

import glob
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sd_tpu.core.schedules import DiffusionSchedule as JaxSchedule
from sd_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sd_tpu.parallel.sharded_sampling import sharded_sample as jax_sharded_sample
from sd_tpu.pipelines.tiled import tiled_apply as jax_tiled_apply
from sd_tpu.samplers import ddim_sample as jax_ddim, plms_sample as jax_plms
from sd_tpu_torch.scripts.dryrun_multigpu import compare_training, moments_of, optimizer_moments
from sd_tpu_torch.scripts.train import build_trainer, parse_args
from torch_parity import torch_threads

REPO = pathlib.Path(__file__).resolve().parents[1]
SHAPES = str(REPO / "configs/sd_tpu/convergence-shapes.yaml")
# the launched processes run one torch thread each and find the repository
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
# fp32 on the CPU: sd_tpu's own bounds (its sharded sampling test, its dryrun, its TP test)
SAMPLE_TOL = 1e-5
STEP_TOL = 5e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _launch(argv, timeout=300):
    proc = subprocess.run(argv, cwd=REPO, env=ENV, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _torchrun(*args):
    return _launch([sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc_per_node", "2", *args])


def jax_eps(x, t, c):
    base = 0.3 * x
    if c is not None:
        base = base + 0.01 * jnp.mean(c, axis=-1)[:, None, None, :1]
    return base


@pytest.fixture(scope="module")
def worker(tmp_path_factory):
    """Both ranks of tests/torch_dist_worker.py over the test's inputs."""
    root = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    inputs = {"x_T": rng.standard_normal((4, 4, 8, 8)).astype(np.float32),
              "cond": rng.standard_normal((4, 4, 8)).astype(np.float32),
              "uncond": rng.standard_normal((4, 4, 8)).astype(np.float32),
              "tile_x": rng.standard_normal((1, 3, 64, 64)).astype(np.float32)}
    np.savez(root / "inputs.npz", **inputs)
    # a one-process checkpoint at twice a rank's batch, for the ranks to resume
    harness, state, data = build_trainer(parse_args(
        ["--tiny", "--device", "cpu", "--batch_size", "4", "--max_steps", "2", "--logdir",
         str(root / "world1"), "--no_images", "--ckpt_every", "100"]))
    harness.fit(state, data)
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests/torch_dist_worker.py"),
                               str(root)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env={**ENV, "RANK": str(r), "LOCAL_RANK": str(r),
                                   "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2"})
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    return root, inputs, dict(np.load(root / "outputs.npz"))


@pytest.mark.parametrize("sampler", ["ddim", "plms"])
def test_sharded_sample_matches_sd_tpu(worker, sampler):
    _, inputs, out = worker
    fn = {"ddim": jax_ddim, "plms": jax_plms}[sampler]
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))
    x_T = nhwc(inputs["x_T"])
    want = jax_sharded_sample(jax_make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2]),
                              fn, jax_eps, JaxSchedule.create(timesteps=100), x_T.shape,
                              jnp.asarray(inputs["cond"]), jax.random.PRNGKey(0),
                              uncond=jnp.asarray(inputs["uncond"]), x_T=x_T,
                              guidance_scale=3.0, num_steps=4)
    np.testing.assert_allclose(out[sampler].transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=SAMPLE_TOL, atol=SAMPLE_TOL)


def test_sharded_ddim_draws_do_not_depend_on_ranks(worker):
    assert float(worker[2]["ddim_eta1_gap"]) < SAMPLE_TOL


def test_tiled_apply_mesh_matches_sd_tpu(worker):
    _, inputs, out = worker
    x = jnp.asarray(inputs["tile_x"].transpose(0, 2, 3, 1))
    mesh = jax_make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    fn = lambda p: jnp.tanh(p) * 0.5 + p
    with mesh:
        want = jax.jit(lambda x: jax_tiled_apply(fn, x, ks=16, stride=8, mesh=mesh))(x)
    assert ((64 - 16) // 8 + 1) ** 2 % 2 == 1  # the patches do not divide over the ranks
    np.testing.assert_allclose(out["tiled"].transpose(0, 2, 3, 1), np.asarray(want),
                               rtol=SAMPLE_TOL, atol=SAMPLE_TOL)


def test_world1_checkpoint_resumes_at_world2(worker):
    out = worker[2]
    assert bool(out["from_world1_ok"]), {k: v for k, v in out.items() if "world1" in k}


def test_world2_checkpoint_resumes_and_loads_at_world1(worker, tmp_path):
    root, _, out = worker
    assert bool(out["resume_equal"]), "world-2 resume differs from the uninterrupted run"
    (tmp_path / "checkpoints").mkdir()
    (tmp_path / "checkpoints" / "last.pt").write_bytes((root / "step2.pt").read_bytes())
    # one process at twice a rank's batch takes the two ranks' steps
    harness, state, data = build_trainer(parse_args(
        ["--tiny", "--device", "cpu", "--batch_size", "4", "--max_steps", "4", "--logdir",
         str(tmp_path), "--no_images", "--ckpt_every", "100"]))
    assert not hasattr(state.optimizer, "consolidate_state_dict")
    harness.fit(state, data, resume=True)
    want = torch.load(root / "run_a" / "checkpoints" / "last.pt", weights_only=True)["state"]
    assert state.step == want["step"] == 4
    names = [n for n, _ in state.unet.named_parameters()]
    got = {"after": {n: p.detach() for n, p in state.unet.named_parameters()},
           "shadow": state.ema.shadow, "moments": optimizer_moments(state.optimizer, names)}
    ref = {"after": want["unet"], "shadow": want["ema"]["shadow"],
           "moments": moments_of(want["optimizer"], names)}
    res = compare_training(got, ref, on_cpu=True)
    assert res["ok"], res


def test_sigusr1_at_one_rank_saves_on_both(worker):
    # the signal's save at step 1, then the save on exit, on each rank
    assert worker[2]["signal_saves"].tolist() == [[1, 3], [1, 3]]


def test_dryrun_legs_on_two_ranks(worker):
    rows = [json.load(open(worker[0] / f"dryrun_rank{r}.json")) for r in range(2)]
    train = rows[0]["train"]
    assert train["ok"] and train["max_abs"] < STEP_TOL and train["ema_max_abs"] < STEP_TOL
    zero = [r["train"]["zero"] for r in rows]
    assert all(z["owned_bytes"] <= z["share_bytes"] + z["largest_bytes"] for z in zero)
    # the EMA shadow is partitioned: each tensor on exactly one rank
    assert sum(z["ema_tensors"] for z in zero) == zero[0]["tensors"]
    assert rows[0]["hsdp"]["ran"] and rows[0]["hsdp"]["ok"]
    assert all(r["pipeline"]["max_u8_diff"] <= 1 for r in rows)
    for r in rows:
        tp = r["tp"]
        assert tp["all_reduces"] == tp["boundaries"] > 0 and tp["sharded_tensors"] > 0
        assert tp["grad_max_abs"] < 2e-5


def test_training_cli_under_torchrun(tmp_path):
    out = _torchrun("-m", "sd_tpu_torch.scripts.train", "--base", SHAPES, "-t", "--device",
                    "cpu", "--backend", "gloo", "--max_steps", "2", "--log_every", "1",
                    "--val_every", "2", "-l", str(tmp_path), "data.params.batch_size=2",
                    "model.params.image_size=16", "data.params.train.params.size=16",
                    "data.params.validation.params.size=16",
                    "data.params.validation.params.length=8")
    lr_lines = [line for line in out.splitlines() if line.startswith("Setting learning rate")]
    assert len(lr_lines) == 1 and "= 2 (devices) * 2 (batchsize)" in lr_lines[0], out
    (run,) = glob.glob(str(tmp_path / "*_convergence-shapes"))
    assert os.path.isfile(os.path.join(run, "checkpoints", "last.pt"))
    assert os.path.isfile(os.path.join(run, "configs", "project.yaml"))
    assert glob.glob(os.path.join(run, "images", "train_samples_step*.png"))
    rows = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [1, 2, 2]
    assert len(glob.glob(os.path.join(run, "tb", "events.out.tfevents.*"))) == 1
