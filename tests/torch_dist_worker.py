"""One rank of the port's two-rank CPU checks (``test_torch_parallel_dist.py``
and ``test_torch_first_stage_dist.py`` start two of these): it imports the
port alone, joins a gloo group through a ``FileStore`` in the test's
directory, runs torch on one thread, and writes what it computed there for
the test to compare.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r python tests/torch_dist_worker.py <dir> [first_stage]

``<dir>/inputs.npz`` holds the test's arrays; rank 0 writes
``<dir>/outputs.npz`` and the training runs' directories, and each rank
its dry-run legs' numbers. With ``first_stage``: the first-stage checks
(:func:`first_stage`), whose numbers rank 0 writes to
``<dir>/first_stage.json``.
"""

import glob
import json
import os
import pathlib
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


def zero_save(out):
    """A ZeRO-1 AdamW and a ZeRO-1 Adam (amsgrad, the first stage's betas)
    over five parameters, one of which never has a gradient, after 3 steps:
    ``optimizer_state_dict``'s tensor gather against
    ``consolidate_state_dict`` + ``state_dict``; rank 0 writes whether the
    two are equal to the bit."""
    from sd_tpu_torch.parallel.mesh import optimizer_state_dict, zero_sharding
    from sd_tpu_torch.scripts.dryrun_multigpu import equal_state

    equal = []
    for cls, kw in ((torch.optim.AdamW, dict(lr=1e-3, weight_decay=0.01)),
                    (torch.optim.Adam, dict(lr=1e-3, betas=(0.5, 0.9), amsgrad=True))):
        g = torch.Generator().manual_seed(0)
        params = [torch.nn.Parameter(torch.randn(s, generator=g))
                  for s in ((7, 5), (64,), (3, 3, 4), (11,), (2, 2))]
        zero = zero_sharding(params, optimizer_class=cls, **kw)
        for step in range(3):
            for i, p in enumerate(params):
                p.grad = None if i == 3 else torch.randn(p.shape, generator=g)
            zero.step()
        gathered = optimizer_state_dict(zero)
        zero.consolidate_state_dict(to=0)
        if torch.distributed.get_rank() == 0:
            want = zero.state_dict()
            equal.append(equal_state(gathered, want) and len(want["state"]) == len(params) - 1)
        else:
            equal.append(gathered is None)
    out["zero_save_equal"] = np.bool_(all(equal))


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


FIRST_STAGE_KL = str(pathlib.Path(__file__).resolve().parents[1]
                     / "configs/sd_tpu/tiny-autoencoder-kl.yaml")
# the tiny KL VAE-GAN's CLI arguments: the discriminator from step 1, 24²
# images
FIRST_STAGE_ARGS = ["-t", "--device", "cpu", "--no_images", "--log_every", "1",
                    "--ckpt_every", "100", "model.params.lossconfig.params.disc_start=0",
                    "data.params.train.params.size=24"]


def first_stage_fit(argv, resume=False, shards=1):
    """The training CLI's first-stage run of ``argv`` (after
    ``FIRST_STAGE_ARGS``) through ``Trainer.fit``; ``shards`` makes its
    trainer the one-process reference of that many ranks. Returns the
    harness and the state."""
    from sd_tpu_torch.scripts.train import build_trainer, parse_args

    harness, state, data = build_trainer(parse_args(FIRST_STAGE_ARGS + argv))
    harness.trainer_obj.shards = shards
    harness.fit(state, data, resume=resume)
    return harness, state


def vae_gan_run(sd):
    """A first-stage checkpoint's state as
    ``dryrun_multigpu.compare_training`` takes it: both optimizers'
    parameters (``ae.``, ``disc.``) and moments."""
    names = {"ae": list(sd["ae"]),
             "disc": [k for k in sd["disc"] if "running" not in k and "num_batches" not in k]}
    run = {"after": {}, "moments": {}}
    for part, opt in (("ae", "ae_opt"), ("disc", "disc_opt")):
        run["after"].update({f"{part}.{k}": sd[part][k] for k in names[part]})
        run["moments"].update({f"{part}.{k}": v
                               for k, v in moments_of(sd[opt], names[part]).items()})
    return run


def _running_stats(disc_sd):
    return {k: v for k, v in disc_sd.items() if "running" in k}


def first_stage(root, device, out):
    """The first stage at two ranks (the tiny KL config, ``disc_start`` 0):

    - ``scripts/dryrun_multigpu.py``'s ``first_stage`` leg on the tiny VQ
      VAE-GAN (under DDP + ZeRO-1 against the one-process reference of 2
      ranks; the KL model's comparison is run A's against the test's
      reference), each rank's numbers in ``first_stage_rank<r>.json``;
    - the test's run A (2 steps of the CLI under ``torch.distributed.run``)
      resumed to 4; each rank's logvar, and rank 0's checkpoint's running
      statistics against both ranks' own;
    - the test's one-process reference checkpoint (2 steps, ``w1``) resumed
      here at two ranks for 2 more, against A (``compare_training``);
    - ``BatchResizeWrapper`` over each rank's shard: the sizes it draws.
    """
    from sd_tpu_torch.scripts import dryrun_multigpu as dryrun
    from sd_tpu_torch.training.trainer import DataModuleFromConfig
    from sd_tpu_torch.training.vae_gan import BatchResizeWrapper

    me = torch.distributed.get_rank()
    opt = dryrun.parse_args(["--tiny", "--device", "cpu", "--legs", "first_stage", "--steps",
                             "2"])
    leg = dryrun.leg_first_stage(opt, device, {}, kinds=("vq",))
    with open(os.path.join(root, f"first_stage_rank{me}.json"), "w") as f:
        json.dump(leg, f)

    (run_a,) = glob.glob(os.path.join(root, "a", "*_a"))
    last_a = os.path.join(run_a, "checkpoints", "last.pt")
    _, state = first_stage_fit(["--resume", run_a, "--max_steps", "4"], resume=True)
    mine = {"logvar": state.logvar.item(),
            "stats": {k: v.tolist() for k, v in _running_stats(state.disc.state_dict()).items()}}
    both = [None, None]
    torch.distributed.all_gather_object(both, mine)
    if me == 0:
        saved = _running_stats(torch.load(last_a, weights_only=True)["state"]["disc"])
        out["logvars"] = [b["logvar"] for b in both]
        out["stats_saved_are_rank0s"] = all(v.tolist() == both[0]["stats"][k]
                                            for k, v in saved.items())
        out["stats_rank1_differ"] = any(both[1]["stats"][k] != both[0]["stats"][k]
                                        for k in saved)
        (w1,) = glob.glob(os.path.join(root, "w1", "*_w1"))
        shutil.copytree(w1, os.path.join(root, "w1_at_2"))
    torch.distributed.barrier()
    _, state = first_stage_fit(["--resume", os.path.join(root, "w1_at_2"), "--max_steps", "4",
                                "--batch_size", "2"], resume=True)
    if me == 0:
        got, want = (torch.load(os.path.join(d, "checkpoints", "last.pt"),
                                weights_only=True)["state"]
                     for d in (os.path.join(root, "w1_at_2"), run_a))
        res = dryrun.compare_training(vae_gan_run(got), vae_gan_run(want), on_cpu=True,
                                      beta2=dryrun.FIRST_STAGE_BETA2)
        out["from_world1"] = {**res, "step": got["step"],
                              "logvar_gap": float((got["logvar"] - want["logvar"]).abs())}

    images = {"target": "sd_tpu_torch.data.synthetic.SyntheticImages",
              "params": {"size": 32, "length": 40}}
    data = BatchResizeWrapper(DataModuleFromConfig(2, images, num_shards=2, shard_index=me),
                              (16, 48))
    sizes = [int(b["image"].shape[1]) for b in data.train_dataloader()]
    both = [None, None]
    torch.distributed.all_gather_object(both, sizes)
    out["resize_sizes"] = both


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b


def main(root: str, mode: str = "") -> None:
    from sd_tpu_torch.parallel.mesh import init_distributed, make_mesh

    torch.set_num_threads(1)
    device = init_distributed("gloo", "cpu", init_method=f"file://{root}/store")
    out = {}
    try:
        if mode == "first_stage":
            first_stage(root, device, out)
            if torch.distributed.get_rank() == 0:
                with open(os.path.join(root, "first_stage.json"), "w") as f:
                    json.dump(out, f)
            return
        inputs = dict(np.load(os.path.join(root, "inputs.npz")))
        mesh = make_mesh(torch.distributed.get_world_size(), 1, "cpu")
        sampling(inputs, out, mesh, device)
        tiling(inputs, out, mesh)
        checkpoints(root, out)
        signal_save(root, out)
        zero_save(out)
        dryrun_legs(root, device)
        if torch.distributed.get_rank() == 0:
            np.savez(os.path.join(root, "outputs.npz"), **out)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
