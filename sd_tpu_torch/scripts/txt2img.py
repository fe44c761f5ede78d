"""txt2img CLI of the PyTorch port, with the flags of ``scripts/txt2img.py``.

    python -m sd_tpu_torch.scripts.txt2img --prompt "..." --ddim_steps 50 \
        --H 512 --W 512 --n_samples 1 --scale 7.5 --seed 42 [--plms | --dpm_solver]

DDIM is the default sampler (``--ddim_eta`` sets its eta); ``--plms`` runs
PLMS and ``--dpm_solver`` DPM-Solver++ 2M. The model is SD v1 at full width
(``--config``, a YAML or JSON model config; SD v1's by default) with seeded
random weights, a reference checkpoint's (``--ckpt`` a ``.ckpt`` file, which
needs ``SD_TPU_BPE_VOCAB``, CLIP's merges file) or one of the port's own
training runs' (``--ckpt`` the run's logdir: its EMA weights and its config),
or the tiny model with ``--tiny``. ``--n_iter`` requests of ``--n_samples``
prompts (or one request of the lines of ``--from-file``) are written to
``<outdir>/samples`` and, together, to a grid of ``--n_rows`` images a row
(``--skip_save``, ``--skip_grid``). The safety checker is on unless
``--no-safety``: armed with ``--safety_ckpt`` (or ``SD_TPU_SAFETY_CKPT``),
an HF ``StableDiffusionSafetyChecker`` ``state_dict``, else untrained (it
scores, flags nothing). ``--C`` and ``--f`` default to the model config's.

``--device`` defaults to ``cuda``; a run that asks for the card and finds
none fails. The int8 serving mode is chosen as in ``sd_tpu``, by
``SD_TPU_INT8`` (for example ``all``, or ``conv,ff,attn,attn_pv,proj``); it
runs on the card only. So are the conv modes: ``SD_TPU_FUSED_CONV=1`` sends
the resnet blocks whose convs pass K7's gate through the fused
GroupNorm+SiLU+conv kernel, and ``SD_TPU_CONV_IMPL=winograd`` sends the
other 3x3 convs that pass K8's gate through the Winograd kernel. The
summary line names the modes.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--prompt", type=str, default="a painting of a virus monster playing guitar")
    p.add_argument("--outdir", type=str, default="outputs/txt2img-samples")
    p.add_argument("--skip_grid", action="store_true")
    p.add_argument("--skip_save", action="store_true")
    p.add_argument("--ddim_steps", "--steps", dest="ddim_steps", type=int, default=50)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--dpm_solver", action="store_true")
    p.add_argument("--fixed_code", action="store_true")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--n_iter", type=int, default=1)
    p.add_argument("--H", "--height", dest="H", type=int, default=512)
    p.add_argument("--W", "--width", dest="W", type=int, default=512)
    p.add_argument("--C", type=int, default=None, help="latent channels (default: the config's)")
    p.add_argument("--f", type=int, default=None,
                   help="downsampling factor (default: the config's)")
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--n_rows", type=int, default=0)
    p.add_argument("--scale", type=float, default=7.5)
    p.add_argument("--from-file", dest="from_file", type=str)
    p.add_argument("--config", type=str, default=None,
                   help="model config (default: the run's for a run-directory --ckpt, else "
                        "SD v1's, configs/stable-diffusion/v1-inference.yaml)")
    p.add_argument("--ckpt", type=str, help="a reference .ckpt, or a training run's logdir")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true", help="use the tiny random-weight model")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--no-watermark", dest="watermark", action="store_false",
                   help="skip the invisible watermark on saved images")
    p.add_argument("--no-safety", dest="safety", action="store_false",
                   help="skip the NSFW safety checker")
    p.add_argument("--safety_ckpt", type=str, default=os.environ.get("SD_TPU_SAFETY_CKPT"),
                   help="HF StableDiffusionSafetyChecker state_dict (.ckpt/.pt); without it "
                        "the checker runs with unreachable thresholds (flags nothing)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    opt = parse_args(argv)
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    from sd_tpu_torch.ops.quant import int8_mode_label
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.utils.image import save_grid, save_image

    pipe, tiny_hw = build_txt2img_pipeline(
        tiny=opt.tiny, config=opt.config, ckpt=opt.ckpt, safety=opt.safety,
        safety_ckpt=opt.safety_ckpt, device=device, seed=opt.seed, watermark=opt.watermark,
        min_hw=min(opt.H, opt.W), latent_channels=opt.C, downsample=opt.f)
    if tiny_hw:
        opt.H, opt.W = min(opt.H, tiny_hw), min(opt.W, tiny_hw)
    sampler = "dpm" if opt.dpm_solver else ("plms" if opt.plms else "ddim")
    if opt.from_file:
        with open(opt.from_file) as f:
            prompts = [line.strip() for line in f if line.strip()]
    else:
        prompts = [opt.prompt] * opt.n_samples

    sample_dir = os.path.join(opt.outdir, "samples")
    os.makedirs(sample_dir, exist_ok=True)
    base_count = len(os.listdir(sample_dir))
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    x_T = None
    if opt.fixed_code:
        x_T = torch.randn((len(prompts), opt.H // pipe.downsample, opt.W // pipe.downsample,
                           pipe.latent_channels), generator=generator, device=device)
    all_samples, seconds, sample_s = [], 0.0, 0.0
    for _ in range(opt.n_iter):
        images = pipe(prompts, generator, height=opt.H, width=opt.W, steps=opt.ddim_steps,
                      guidance_scale=opt.scale, x_T=x_T, sampler=sampler, eta=opt.ddim_eta)
        seconds += pipe.last_timings["total_s"]
        sample_s += pipe.last_timings["sample_s"]
        all_samples.append(images)
        if not opt.skip_save:
            for img in images:
                save_image(img, os.path.join(sample_dir, f"{base_count:05}.png"))
                base_count += 1
    if not opt.skip_grid:
        save_grid(np.concatenate(all_samples), os.path.join(opt.outdir, "grid-0000.png"),
                  n_rows=opt.n_rows or len(prompts))
    ldm = pipe.ldm
    label = int8_mode_label(ldm.int8_mode, device, next(ldm.parameters()).dtype)
    print(f"{sum(len(s) for s in all_samples)} samples ({sampler}) in {seconds:.2f} s "
          f"(sampling {sample_s:.2f} s, {label}, fused conv {ldm.fused_conv}, conv "
          f"{ldm.conv_impl}) at {opt.outdir}")


if __name__ == "__main__":
    main()
