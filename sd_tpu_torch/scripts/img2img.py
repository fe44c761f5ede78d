"""img2img (SDEdit) CLI of the PyTorch port, with the flags of
``scripts/img2img.py``.

    python -m sd_tpu_torch.scripts.img2img --init-img in.png --prompt "..." \
        --strength 0.75 --ddim_steps 50 --scale 7.5 --n_samples 1 --n_iter 1
    python -m sd_tpu_torch.scripts.img2img --init-img in.png --tiny --device cpu

The init image is cropped to multiples of 32. Each of ``--n_iter`` requests
of ``--n_samples`` copies of ``--prompt`` writes its images to
``<outdir>/NNNNN.png``; one generator seeded ``--seed`` draws for all of
them. The model is built as the txt2img CLI builds it (SD v1 at full width
with seeded random weights, ``--config``, ``--ckpt`` a reference ``.ckpt``
with ``SD_TPU_BPE_VOCAB`` or a training run's logdir, or ``--tiny``),
without the safety checker and the watermark, as ``sd_tpu``'s img2img runs
neither. ``--device`` defaults to ``cuda``; a run that asks for the card and
finds none fails.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--prompt", type=str, default="a fantasy landscape")
    p.add_argument("--init-img", dest="init_img", type=str, required=True)
    p.add_argument("--outdir", type=str, default="outputs/img2img-samples")
    p.add_argument("--ddim_steps", "--steps", dest="ddim_steps", type=int, default=50)
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--n_iter", type=int, default=1)
    p.add_argument("--scale", type=float, default=7.5)
    p.add_argument("--strength", type=float, default=0.75)
    p.add_argument("--config", type=str, default=None,
                   help="model config (default: the run's for a run-directory --ckpt, else "
                        "SD v1's, configs/stable-diffusion/v1-inference.yaml)")
    p.add_argument("--ckpt", type=str, help="a reference .ckpt, or a training run's logdir")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true", help="use the tiny random-weight model")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    opt = parse_args(argv)
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.pipelines.img2img import Img2ImgPipeline
    from sd_tpu_torch.utils.image import load_image, save_image

    base, _ = build_txt2img_pipeline(tiny=opt.tiny, config=opt.config, ckpt=opt.ckpt,
                                     safety=False, watermark=False, device=device,
                                     seed=opt.seed)
    pipe = Img2ImgPipeline(base)
    init = load_image(opt.init_img)
    os.makedirs(opt.outdir, exist_ok=True)
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    count, seconds = 0, 0.0
    for _ in range(opt.n_iter):
        images = pipe(init, [opt.prompt] * opt.n_samples, generator, strength=opt.strength,
                      steps=opt.ddim_steps, guidance_scale=opt.scale)
        seconds += pipe.last_timings["total_s"]
        for img in images:
            save_image(img, os.path.join(opt.outdir, f"{count:05}.png"))
            count += 1
    print(f"Done: {count} samples (strength {opt.strength}, DDIM {opt.ddim_steps}, t_enc "
          f"{int(opt.strength * opt.ddim_steps)}) in {seconds:.2f} s at {opt.outdir}")


if __name__ == "__main__":
    main()
