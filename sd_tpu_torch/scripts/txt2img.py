"""txt2img CLI of the PyTorch port, with the flags of ``scripts/txt2img.py``
for this path.

    python -m sd_tpu_torch.scripts.txt2img --plms --prompt "..." \
        --ddim_steps 50 --H 512 --W 512 --n_samples 1 --scale 7.5 --seed 42

Runs SD v1 at full width with seeded random weights (no checkpoint loading
yet), or the tiny model with ``--tiny``. ``--device`` defaults to ``cuda``;
a run that asks for the card and finds none fails. The int8 serving mode
is chosen as in ``sd_tpu``, by ``SD_TPU_INT8`` (for example ``all``, or
``conv,ff,attn,attn_pv,proj``); it runs on the card only. So are the conv
modes: ``SD_TPU_FUSED_CONV=1`` sends the resnet blocks whose convs pass
K7's gate through the fused GroupNorm+SiLU+conv kernel, and
``SD_TPU_CONV_IMPL=winograd`` sends the other 3x3 convs that pass K8's gate
through the Winograd kernel. The summary line names the modes.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--prompt", type=str, default="a painting of a virus monster playing guitar")
    p.add_argument("--outdir", type=str, default="outputs/txt2img-samples")
    p.add_argument("--ddim_steps", "--steps", dest="ddim_steps", type=int, default=50)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--fixed_code", action="store_true")
    p.add_argument("--H", "--height", dest="H", type=int, default=512)
    p.add_argument("--W", "--width", dest="W", type=int, default=512)
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--scale", type=float, default=7.5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true", help="use the tiny random-weight model")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--no-watermark", dest="watermark", action="store_false",
                   help="skip the invisible watermark on saved images")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    opt = parse_args(argv)
    if not opt.plms:
        raise SystemExit("only the PLMS sampler is ported: pass --plms")
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    from PIL import Image

    from sd_tpu_torch.ops.quant import int8_mode_label
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline

    pipe, tiny_hw = build_txt2img_pipeline(tiny=opt.tiny, device=device, seed=opt.seed,
                                           watermark=opt.watermark, min_hw=min(opt.H, opt.W))
    if tiny_hw:
        opt.H, opt.W = min(opt.H, tiny_hw), min(opt.W, tiny_hw)
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    prompts = [opt.prompt] * opt.n_samples
    x_T = None
    if opt.fixed_code:
        x_T = torch.randn((len(prompts), opt.H // pipe.downsample, opt.W // pipe.downsample,
                           pipe.latent_channels), generator=generator, device=device)
    images = pipe(prompts, generator, height=opt.H, width=opt.W, steps=opt.ddim_steps,
                  guidance_scale=opt.scale, x_T=x_T)

    sample_dir = os.path.join(opt.outdir, "samples")
    os.makedirs(sample_dir, exist_ok=True)
    base_count = len(os.listdir(sample_dir))
    for i, img in enumerate(images):
        Image.fromarray(img).save(os.path.join(sample_dir, f"{base_count + i:05}.png"))
    t = pipe.last_timings
    label = int8_mode_label(pipe.ldm.int8_mode, device, next(pipe.ldm.parameters()).dtype)
    ldm = pipe.ldm
    print(f"{len(images)} samples in {t['total_s']:.2f} s (sampling {t['sample_s']:.2f} s, "
          f"{label}, fused conv {ldm.fused_conv}, conv {ldm.conv_impl}) at {opt.outdir}")


if __name__ == "__main__":
    main()
