"""Training CLI of the PyTorch port (the counterpart of ``main.py``).

    python -m sd_tpu_torch.scripts.train --base <cfg.yaml> [<cfg2.yaml> ...] -t \
        [--resume <logdir>] [-n name] [nested.key=value ...]
    python -m sd_tpu_torch.scripts.train --max_steps 5 --logdir logs/sd-v1
    python -m sd_tpu_torch.scripts.train --tiny --device cpu --max_steps 2 --logdir logs/tiny

With ``--base`` the configs are merged left to right and the dotlist
overrides applied, as ``main.py`` does; the run's directory is
``<logdir>/<time>_<name>`` (``name``: ``-n``, else the first config's file
name), or the directory given to ``--resume``, whose ``configs/`` are read
again before the ``--base`` configs. A first-stage model (``AutoencoderKL``,
``VQModel`` or ``VQModelInterface``, as ``main.py`` sends them to its
first-stage trainer) trains as a VAE-GAN (``training/vae_gan.py``, KL or VQ
mode) with its ``lossconfig``'s parameters and ``batch_resize_range``; a
``LatentDiffusion`` trains with the LDM trainer under any conditioning key
and the config's ``cond_stage_trainable``, ``learn_logvar``/``logvar_init``,
``scale_by_std``, ``loss_type``, ``l_simple_weight``,
``original_elbo_weight`` and ``use_ema``. Only ``-t`` trains; without it
the run is built and its config written.

Without ``--base`` the CLI trains SD v1 at full width (860M UNet; frozen
kl-f8 encoder and CLIP ViT-L/14 text tower; 512² images, batch 4) or, with
``--tiny``, the tiny model, in ``--logdir`` itself, with or without ``-t``.

Every model starts from seeded random weights: real weights are not in the
repository. The data is the config's: synthetic images, or the LSUN and
ImageNet datasets (``data/lsun.py``, ``data/imagenet.py``) over files the
user provides under the config's paths. The LR is the config's
``base_learning_rate`` (in ``model.params``, else in ``model``) times the
batch size (``--scale_lr false`` keeps it as it is), times the config's LR
schedule where it has one. ``--device`` defaults to ``cuda``; a run that
asks for the card and finds none fails. ``--resume`` without a directory
continues the run in ``--logdir`` from ``checkpoints/last.pt``. The image
logger writes its grids to ``<logdir>/images`` at steps 1, 2, 4, 8 and
every 750 (``--no_images`` turns it off); ``--val_every N`` (LDM
runs) validates every N steps and keeps the best 3 checkpoints by the
config's ``monitor`` as ``checkpoints/step_<n>.pt``. A ``--base`` LDM run
writes each logged step's loss and it/s and each validation's metrics to
``<logdir>/metrics.jsonl`` and to TensorBoard events under ``<logdir>/tb``,
as ``main.py`` does. SIGUSR1 saves
``last.pt`` at the end of the step it lands in. The run's config goes to
``<logdir>/configs/project.yaml`` (as JSON, which is YAML), so that
``build_txt2img_pipeline(ckpt=<logdir>)`` and the txt2img CLI's
``--ckpt <logdir>`` can sample from an LDM run.

Data parallelism: under ``torchrun`` an LDM run or a first-stage run
trains on every rank,

    torchrun --nproc_per_node N -m sd_tpu_torch.scripts.train ... [--backend nccl|gloo]

``--backend`` defaults to the device's (``nccl`` for ``cuda``, ``gloo``
for ``cpu``; ``gloo`` on the card is what puts several ranks on one card).
Each rank loads its shard of the data (``idx[rank::N]`` at the config's
batch size, a rank's), the LR scales by N (the ranks) times the batch
size, the trained modules run under DDP (a first stage's autoencoder and
discriminator under one each: ``training/vae_gan.py``), and ``--zero``
(ZeRO-1: the optimizers' moments, and an LDM's EMA shadow, partitioned
over the ranks) is on by default for N > 1. Rank 0 alone writes the
config, the checkpoints (in the one-process layout), the images and the
metrics; the run's directory is rank 0's. Without ``WORLD_SIZE`` in the
environment the CLI runs as one process, as it always did.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from sd_tpu_torch.parallel.mesh import BACKENDS, is_main_process, launched, rank, world_size


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("-b", "--base", nargs="*", default=[],
                   help="config files, merged left to right")
    p.add_argument("-t", "--train", action="store_true",
                   help="train a --base run (the built-in configs always train)")
    p.add_argument("-r", "--resume", nargs="?", const=True, default="",
                   help="resume the run in the directory given, or in --logdir")
    p.add_argument("-n", "--name", type=str, default="")
    p.add_argument("--tiny", action="store_true", help="train the tiny random-weight model")
    p.add_argument("-l", "--logdir", type=str, default="logs/train")
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("--max_steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=None,
                   help="default: the config's (4 for SD v1, 2 for --tiny)")
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--val_every", type=int, default=0,
                   help="validate every N steps (0: never)")
    p.add_argument("--no_images", action="store_true",
                   help="skip the image logger's grids (each runs DDIM 20 and 9 decodes)")
    p.add_argument("--scale_lr", type=lambda v: v.lower() != "false", default=True,
                   help="scale the base LR by the batch size (default true)")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--backend", type=str, default=None, choices=BACKENDS,
                   help="the process group's backend under torchrun (default: nccl for "
                        "cuda, gloo for cpu)")
    p.add_argument("--zero", type=lambda v: v.lower() != "false", default=None,
                   help="ZeRO-1 under torchrun (default: true for more than one rank)")
    opt, unknown = p.parse_known_args(argv)
    opt.dotlist = [a for a in unknown if "=" in a and not a.startswith("-")]
    rest = [a for a in unknown if a not in opt.dotlist]
    if rest:
        p.error(f"unrecognized arguments: {' '.join(rest)}")
    return opt


def from_base(opt: argparse.Namespace) -> bool:
    """Whether the run's config comes from ``--base`` files (or a resumed
    run directory's), not from the built-in SD v1 or tiny config."""
    return bool(opt.base) or (isinstance(opt.resume, str) and bool(opt.resume))


def assemble_config(opt: argparse.Namespace) -> Tuple[Dict[str, Any], str]:
    """``(config, logdir)``: the merged configs (a resumed run's own, then
    ``--base``'s) with the dotlist applied and the run's directory, or the
    built-in config and ``--logdir``."""
    from sd_tpu_torch.utils.config import apply_dotlist, load_yaml, merge_configs, train_config

    if not from_base(opt):
        return apply_dotlist(train_config(opt.tiny, opt.batch_size), opt.dotlist), opt.logdir
    configs = [load_yaml(b) for b in opt.base]
    if opt.resume:
        logdir = (opt.logdir if opt.resume is True else opt.resume).rstrip("/")
        cfgdir = os.path.join(logdir, "configs")
        configs = [load_yaml(os.path.join(cfgdir, f)) for f in sorted(os.listdir(cfgdir))
                   ] + configs
    else:
        now = datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")
        name = opt.name or os.path.splitext(os.path.basename(opt.base[0]))[0]
        logdir = [os.path.join(opt.logdir, f"{now}_{name}")]
        if world_size() > 1:  # rank 0's clock names the run
            torch.distributed.broadcast_object_list(logdir, src=0)
        logdir = logdir[0]
    config = apply_dotlist(merge_configs(configs), opt.dotlist)
    if opt.batch_size:
        config["data"]["params"]["batch_size"] = opt.batch_size
    return config, logdir


def build_trainer(opt: argparse.Namespace, device: Optional[torch.device] = None):
    """Returns ``(harness, state, data)``: the ``Trainer`` (its ``logdir``
    the run's directory), the initial trainer state and the data module;
    on ``device`` (default ``--device``), over this rank's shard of the
    data where a process group is up."""
    from sd_tpu_torch.training.trainer import DataModuleFromConfig

    device = torch.device(opt.device) if device is None else device
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    config, logdir = assemble_config(opt)
    harness_args = dict(logdir=logdir, max_steps=opt.max_steps, ckpt_every=opt.ckpt_every,
                        seed=opt.seed, log_every=opt.log_every)
    model_cfg = config["model"]
    data_cfg = dict(config["data"]["params"])
    data = DataModuleFromConfig(**data_cfg, num_shards=world_size(), shard_index=rank())
    if model_cfg["target"].split(".")[-1] in ("AutoencoderKL", "VQModel", "VQModelInterface"):
        harness, state, data = _first_stage(opt, model_cfg, data, device, harness_args)
    else:
        harness, state = _latent_diffusion(opt, model_cfg, data_cfg["batch_size"], device,
                                           harness_args)
    if is_main_process():
        write_project_config(logdir, config)
    return harness, state, data


def _learning_rate(opt, model_cfg: Dict[str, Any], batch_size: int, default: float) -> float:
    from sd_tpu_torch.training.trainer import scale_learning_rate

    base_lr = model_cfg.get("params", {}).get("base_learning_rate",
                                              model_cfg.get("base_learning_rate", default))
    return scale_learning_rate(base_lr, batch_size, world_size(), scale=opt.scale_lr)


def _parallel(opt) -> Dict[str, Any]:
    """The trainer's data parallelism under ``torchrun``: DDP over the
    job's ranks, ZeRO-1 by default from 2 of them; nothing otherwise."""
    if not launched():
        return {}
    zero = opt.zero if opt.zero is not None else world_size() > 1
    return dict(data_group=torch.distributed.group.WORLD, zero=zero)


def _latent_diffusion(opt, model_cfg, batch_size: int, device, harness_args):
    from sd_tpu_torch.training.diffusion_loss import create_train_state
    from sd_tpu_torch.training.trainer import ImageLogger, Trainer
    from sd_tpu_torch.utils.config import build_latent_diffusion, instantiate_from_config
    from sd_tpu_torch.utils.profiling import MetricsWriter

    mp = model_cfg["params"]
    ldm = build_latent_diffusion(model_cfg, device=device, dtype=torch.float32, seed=opt.seed)
    lr = _learning_rate(opt, model_cfg, batch_size, 1e-4)
    sched = mp.get("scheduler_config")
    schedule_fn = instantiate_from_config(sched) if sched else None
    train_cond_stage = bool(mp.get("cond_stage_trainable", False))
    if train_cond_stage and is_main_process():
        print("LatentDiffusion: Also optimizing conditioner params!")
    trainer_obj, state = create_train_state(
        ldm, lr, schedule_fn, loss_type=mp.get("loss_type", "l2"),
        l_simple_weight=float(mp.get("l_simple_weight", 1.0)),
        original_elbo_weight=float(mp.get("original_elbo_weight", 0.0)),
        use_ema=bool(mp.get("use_ema", True)), train_cond_stage=train_cond_stage,
        learn_logvar=bool(mp.get("learn_logvar", False)),
        logvar_init=float(mp.get("logvar_init", 0.0)),
        scale_by_std=bool(mp.get("scale_by_std", False)), **_parallel(opt))
    logdir = harness_args["logdir"]
    main = is_main_process()
    # a --base run logs its steps and validations as main.py's does:
    # <logdir>/metrics.jsonl and TensorBoard events under <logdir>/tb
    harness = Trainer(trainer_obj=trainer_obj, val_every=opt.val_every,
                      monitor=mp.get("monitor"),
                      image_logger=None if opt.no_images or not main else ImageLogger(logdir),
                      metrics_writer=MetricsWriter(logdir) if from_base(opt) and main else None,
                      **harness_args)
    return harness, state


def _first_stage(opt, model_cfg, data, device, harness_args):
    from sd_tpu_torch.training.trainer import ImageLogger, Trainer
    from sd_tpu_torch.training.vae_gan import BatchResizeWrapper, build_vae_gan

    p = model_cfg["params"]
    if p.get("batch_resize_range") is not None:
        # one seed on every rank: the ranks draw the same sizes
        data = BatchResizeWrapper(data, tuple(p["batch_resize_range"]))
        if is_main_process():
            print(f"{model_cfg['target'].split('.')[-1]}: Using per-batch resizing in range "
                  f"{tuple(p['batch_resize_range'])}.")
    lr = _learning_rate(opt, model_cfg, data.batch_size, 4.5e-6)
    trainer_obj, state = build_vae_gan(model_cfg, device, opt.seed, lr, **_parallel(opt))
    logger = None if opt.no_images or not is_main_process() else ImageLogger(
        harness_args["logdir"])
    return Trainer(trainer_obj=trainer_obj, image_logger=logger, **harness_args), state, data


def write_project_config(logdir: str, config: dict) -> str:
    """``<logdir>/configs/project.yaml``: the run's config, as JSON."""
    path = os.path.join(logdir, "configs", "project.yaml")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(config, f, indent=1)
    return path


def main(argv: Optional[Sequence[str]] = None) -> None:
    from sd_tpu_torch.parallel.mesh import init_distributed

    opt = parse_args(argv)
    device = None
    if launched():
        backend = opt.backend or ("nccl" if torch.device(opt.device).type == "cuda" else "gloo")
        device = init_distributed(backend, opt.device)
    try:
        harness, state, data = build_trainer(opt, device)
        if opt.train or not from_base(opt):
            harness.fit(state, data, resume=bool(opt.resume))
        if is_main_process():
            print(f"Done at step {state.step}. Logs at {harness.logdir}")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
