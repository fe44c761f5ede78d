"""Inpainting CLI of the PyTorch port, with the flags of ``scripts/inpaint.py``.

    python -m sd_tpu_torch.scripts.inpaint --indir in/ --outdir out/ --steps 50
    python -m sd_tpu_torch.scripts.inpaint --indir in/ --outdir out/ --tiny --device cpu

``--indir`` holds image/mask pairs, ``<name>.png`` beside ``<name>_mask.png``
(a mask pixel above 127 in its first channel marks the region to fill).
Each pair is inpainted by concat-conditioned DDIM (``InpaintPipeline``) and
the composite written to ``<outdir>/<name>.png``. The model is
``--config`` (the port's copy of CompVis's ``inpainting_big`` config by
default: a VQ-f4 first stage that is also the cond stage) with the weights
of a reference ``--ckpt``, or seeded random weights without one, in bf16
on the card; ``--tiny`` builds the tiny concat model of
``scripts/inpaint.py --tiny``. One generator seeded ``--seed`` draws every
pair's x_T in turn. ``--device`` defaults to ``cuda``; a run that asks for
the card and finds none fails.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np
import torch

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "configs", "inpainting_big.yaml")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--indir", type=str, required=True,
                   help="directory of <name>.png and <name>_mask.png pairs")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--steps", type=int, default=50, help="DDIM steps")
    p.add_argument("--config", type=str, default=DEFAULT_CONFIG)
    p.add_argument("--ckpt", type=str, help="a reference .ckpt (random weights without one)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true", help="use the tiny random-weight model")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build_pipeline(opt: argparse.Namespace):
    """The ``InpaintPipeline`` that ``opt`` asks for."""
    from sd_tpu_torch.pipelines.build import inference_dtype
    from sd_tpu_torch.pipelines.img2img import InpaintPipeline
    from sd_tpu_torch.utils.config import (build_latent_diffusion, load_yaml,
                                           tiny_inpaint_model_config)
    from sd_tpu_torch.utils.port import load_torch_state_dict

    device = torch.device(opt.device)
    if opt.tiny:
        model_cfg, state_dict = tiny_inpaint_model_config(), None
    else:
        cfg = load_yaml(opt.config)
        model_cfg = cfg["model"] if "model" in cfg else cfg
        state_dict = load_torch_state_dict(opt.ckpt) if opt.ckpt else None
    ldm = build_latent_diffusion(model_cfg, device=device, dtype=inference_dtype(device),
                                 seed=opt.seed, state_dict=state_dict)
    ch_mult = model_cfg["params"]["first_stage_config"]["params"]["ddconfig"]["ch_mult"]
    return InpaintPipeline(ldm=ldm, downsample=2 ** (len(ch_mult) - 1))


def main(argv: Optional[Sequence[str]] = None) -> list:
    """Runs the CLI; returns the paths written."""
    opt = parse_args(argv)
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    from sd_tpu_torch.utils.image import load_image, save_image

    pipe = build_pipeline(opt)
    masks = sorted(glob.glob(os.path.join(opt.indir, "*_mask.png")))
    print(f"Found {len(masks)} inputs.")
    os.makedirs(opt.outdir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    written = []
    for mask_path in masks:
        image_path = mask_path.replace("_mask.png", ".png")
        mask = (load_image(mask_path)[..., 0] > 127).astype(np.float32)
        out = pipe(load_image(image_path), mask, generator, steps=opt.steps)
        written.append(os.path.join(opt.outdir, os.path.basename(image_path)))
        save_image(out[0], written[-1])
        print(f"{os.path.basename(image_path)}: {pipe.last_timings['total_s']:.3f} s")
    print(f"Done -> {opt.outdir}")
    return written


if __name__ == "__main__":
    main()
