"""LDM training CLI of the PyTorch port (the counterpart of ``main.py``'s
LDM path).

    python -m sd_tpu_torch.scripts.train --max_steps 5 --logdir logs/sd-v1
    python -m sd_tpu_torch.scripts.train --tiny --device cpu --max_steps 2 --logdir logs/tiny

Trains SD v1 at full width (860M UNet; frozen kl-f8 encoder and CLIP ViT-L/14
text tower; 512² images, batch 4) or, with ``--tiny``, the tiny model, from
seeded random weights on synthetic images with token captions: real SD
weights and datasets are not in the repository. The LR is
``scale_learning_rate`` of the config's base LR, times the config's
LambdaLinear schedule where it has one; EMA follows the config's ``use_ema``.
``--device`` defaults to ``cuda``; a run that asks for the card and finds
none fails. ``--resume`` continues from ``<logdir>/checkpoints/last.pt``.
The image logger writes its grids to ``<logdir>/images`` at steps 1, 2, 4,
8 and every 750 (``--no_images`` turns it off); ``--val_every N`` runs
validation every N steps on two batches of other synthetic images and
keeps the best 3 checkpoints by the config's ``monitor``
(``val/loss_simple_ema`` for SD v1, which needs the EMA shadow) as
``<logdir>/checkpoints/step_<n>.pt``. SIGUSR1 saves ``last.pt`` at the end
of the step it lands in.
The run's config goes to ``<logdir>/configs/project.yaml`` (as JSON, which
is YAML), so that ``build_txt2img_pipeline(ckpt=<logdir>)`` and the txt2img
CLI's ``--ckpt <logdir>`` can sample from the run.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--tiny", action="store_true", help="train the tiny random-weight model")
    p.add_argument("-l", "--logdir", type=str, default="logs/train")
    p.add_argument("-r", "--resume", action="store_true",
                   help="resume from the logdir's last checkpoint")
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
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build_trainer(opt: argparse.Namespace):
    """Returns ``(harness, state, data)``: the ``Trainer``, the initial
    ``TrainState`` and the ``DataModuleFromConfig`` of this run."""
    from sd_tpu_torch.training.diffusion_loss import create_train_state
    from sd_tpu_torch.training.lr_schedules import lambda_linear
    from sd_tpu_torch.training.trainer import (
        DataModuleFromConfig,
        ImageLogger,
        Trainer,
        scale_learning_rate,
    )
    from sd_tpu_torch.utils.config import build_latent_diffusion, train_config

    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    config = train_config(tiny=opt.tiny, batch_size=opt.batch_size)
    model_cfg, data_cfg = config["model"], config["data"]["params"]
    mp = model_cfg["params"]
    ldm = build_latent_diffusion(model_cfg, device=device, dtype=torch.float32, seed=opt.seed)
    data = DataModuleFromConfig(**data_cfg)

    base_lr = model_cfg.get("base_learning_rate", mp.get("base_learning_rate", 1e-4))
    lr = scale_learning_rate(base_lr, data_cfg["batch_size"], 1)
    schedule_fn = None
    if sched := mp.get("scheduler_config"):
        if sched["target"] != "ldm.lr_scheduler.LambdaLinearScheduler":
            raise NotImplementedError(f"the port has LambdaLinearScheduler only, not "
                                      f"{sched['target']!r}")
        schedule_fn = lambda_linear(**sched["params"])
    trainer_obj, state = create_train_state(
        ldm, lr, schedule_fn,
        loss_type=mp.get("loss_type", "l2"),
        l_simple_weight=float(mp.get("l_simple_weight", 1.0)),
        original_elbo_weight=float(mp.get("original_elbo_weight", 0.0)),
        use_ema=bool(mp.get("use_ema", True)))
    harness = Trainer(trainer_obj=trainer_obj, logdir=opt.logdir, max_steps=opt.max_steps,
                      ckpt_every=opt.ckpt_every, seed=opt.seed, log_every=opt.log_every,
                      val_every=opt.val_every, monitor=mp.get("monitor"),
                      image_logger=None if opt.no_images else ImageLogger(opt.logdir))
    write_project_config(opt.logdir, config)
    return harness, state, data


def write_project_config(logdir: str, config: dict) -> str:
    """``<logdir>/configs/project.yaml``: the run's config, as JSON."""
    path = os.path.join(logdir, "configs", "project.yaml")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(config, f, indent=1)
    return path


def main(argv: Optional[Sequence[str]] = None) -> None:
    opt = parse_args(argv)
    harness, state, data = build_trainer(opt)
    harness.fit(state, data, resume=opt.resume)
    print(f"Done at step {state.step}. Logs at {opt.logdir}")


if __name__ == "__main__":
    main()
