"""One rank of the port's two-rank CPU checks (``test_torch_parallel_dist.py``
starts two of these): it imports the port alone, joins a gloo group through
a ``FileStore`` in the test's directory, runs torch on one thread, and
writes what it computed there for the test to compare.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r python tests/torch_dist_worker.py <dir>

``<dir>/inputs.npz`` holds the test's arrays; rank 0 writes
``<dir>/outputs.npz`` and the training runs' directories, and each rank
its dry-run legs' numbers.
"""

import json
import os
import shutil
import sys

import numpy as np
import torch

from sd_tpu_torch.scripts.dryrun_multigpu import compare_training, moments_of


def eps_model(x, t, c):
    """test_sharded_sampling.py's toy model, NCHW: 0.3 x plus 0.01 times
    the mean of c's first token."""
    base = 0.3 * x
    if c is not None:
        base = base + 0.01 * c.mean(dim=-1)[:, :1, None, None]
    return base


def sampling(inputs, out, mesh, device):
    from sd_tpu_torch.core.schedules import DiffusionSchedule
    from sd_tpu_torch.parallel.sharded_sampling import sharded_sample
    from sd_tpu_torch.samplers.ddim import ddim_sample
    from sd_tpu_torch.samplers.plms import plms_sample

    sched = DiffusionSchedule.create(timesteps=100)
    x_T = torch.from_numpy(inputs["x_T"])
    cond, uncond = torch.from_numpy(inputs["cond"]), torch.from_numpy(inputs["uncond"])
    for name, fn in (("ddim", ddim_sample), ("plms", plms_sample)):
        out[name] = sharded_sample(mesh, fn, eps_model, sched, tuple(x_T.shape), cond,
                                   uncond=uncond, x_T=x_T, guidance_scale=3.0,
                                   num_steps=4).numpy()
    # DDIM at eta 1 draws its noise: two ranks give one process's result
    shape = tuple(x_T.shape)
    two = sharded_sample(mesh, ddim_sample, eps_model, sched, shape, cond,
                         generator=torch.Generator().manual_seed(7), eta=1.0, num_steps=4)
    g = torch.Generator().manual_seed(7)
    one = ddim_sample(eps_model, sched, torch.randn(shape, generator=g), cond, generator=g,
                      eta=1.0, num_steps=4)
    out["ddim_eta1_gap"] = np.float64((two - one).abs().max())


def tiling(inputs, out, mesh):
    from sd_tpu_torch.pipelines.tiled import tiled_apply

    x = torch.from_numpy(inputs["tile_x"])
    out["tiled"] = tiled_apply(lambda p: torch.tanh(p) * 0.5 + p, x, ks=16, stride=8,
                               mesh=mesh).numpy()


def _fit(logdir, steps, resume=False):
    from sd_tpu_torch.scripts.train import build_trainer, parse_args

    harness, state, data = build_trainer(parse_args(
        ["--tiny", "--device", "cpu", "--max_steps", str(steps), "--logdir", logdir,
         "--no_images", "--log_every", "1", "--ckpt_every", "100"]))
    harness.fit(state, data, resume=resume)


def checkpoints(root, out):
    """4 steps at two ranks in one run (A), and 2, a save and 2 more after
    a resume (B); rank 0 compares the two last.pt files bit for bit and
    keeps B's step-2 checkpoint for the test to load at one rank. Then the
    test's one-process checkpoint (2 steps at twice a rank's batch, in
    ``world1``) resumed here for 2 more, compared with A
    (``dryrun_multigpu.compare_training``)."""
    a, b, w1 = (os.path.join(root, d) for d in ("run_a", "run_b", "world1"))
    _fit(a, 4)
    _fit(b, 2)
    if torch.distributed.get_rank() == 0:
        shutil.copy(os.path.join(b, "checkpoints", "last.pt"), os.path.join(root, "step2.pt"))
    torch.distributed.barrier()
    _fit(b, 4, resume=True)
    _fit(w1, 4, resume=True)
    if torch.distributed.get_rank() == 0:
        sa, sb, s1 = (torch.load(os.path.join(d, "checkpoints", "last.pt"),
                                 weights_only=True)["state"] for d in (a, b, w1))
        out["resume_equal"] = np.bool_(_equal(sa, sb))
        res = compare_training(_run(s1), _run(sa), on_cpu=True)
        out.update({f"from_world1_{k}": np.float64(v) for k, v in res.items()})


def signal_save(root, out):
    """3 steps at two ranks with a SIGUSR1 to rank 1 alone after step 1:
    both ranks save at the end of step 1 (the flag agreed over the ranks),
    then on exit; ``out["signal_saves"]`` holds each rank's saved steps."""
    import signal

    from sd_tpu_torch.scripts.train import build_trainer, parse_args
    from sd_tpu_torch.training import trainer as port_trainer

    harness, state, data = build_trainer(parse_args(
        ["--tiny", "--device", "cpu", "--max_steps", "3", "--logdir",
         os.path.join(root, "run_signal"), "--no_images", "--ckpt_every", "100"]))
    saved, real_save = [], port_trainer.save_last

    def recording_save(ckpt_dir, state_, meta):
        saved.append(state_.step)
        return real_save(ckpt_dir, state_, meta)

    step = harness.trainer_obj.train_step

    def step_then_signal(state_, batch, generator):
        aux = step(state_, batch, generator)
        if state_.step == 1 and torch.distributed.get_rank() == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        return aux

    harness.trainer_obj.train_step = step_then_signal
    port_trainer.save_last = recording_save
    try:
        harness.fit(state, data)
    finally:
        port_trainer.save_last = real_save
    both = [None, None]
    torch.distributed.all_gather_object(both, saved)
    out["signal_saves"] = np.asarray(both)


def _run(sd):
    """A checkpoint's state as dryrun_multigpu.compare_training takes it."""
    names = list(sd["unet"])
    return {"after": sd["unet"], "shadow": sd["ema"]["shadow"],
            "moments": moments_of(sd["optimizer"], names)}


def dryrun_legs(root, device):
    """scripts/dryrun_multigpu.py's train, hsdp, pipeline and tp legs on the
    tiny model (2 accumulated micro-batches, 2 steps at a global batch of
    8); each rank writes its numbers to ``dryrun_rank<r>.json``."""
    from sd_tpu_torch.scripts import dryrun_multigpu as dryrun

    opt = dryrun.parse_args(["--tiny", "--device", "cpu", "--legs", "train,hsdp,pipeline,tp",
                             "--batch", "8", "--accumulate", "2", "--steps", "2"])
    shared, result = {}, {}
    for leg in opt.legs:
        result[leg] = getattr(dryrun, f"leg_{leg}")(opt, device, shared)
    with open(os.path.join(root, f"dryrun_rank{torch.distributed.get_rank()}.json"), "w") as f:
        json.dump(result, f)


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def main(root: str) -> None:
    from sd_tpu_torch.parallel.mesh import init_distributed, make_mesh

    torch.set_num_threads(1)
    device = init_distributed("gloo", "cpu", init_method=f"file://{root}/store")
    inputs = dict(np.load(os.path.join(root, "inputs.npz")))
    out = {}
    try:
        mesh = make_mesh(torch.distributed.get_world_size(), 1, "cpu")
        sampling(inputs, out, mesh, device)
        tiling(inputs, out, mesh)
        checkpoints(root, out)
        signal_save(root, out)
        dryrun_legs(root, device)
        if torch.distributed.get_rank() == 0:
            np.savez(os.path.join(root, "outputs.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
