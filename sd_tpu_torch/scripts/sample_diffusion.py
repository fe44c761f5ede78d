"""Bulk unconditional or class-conditional sampling of the PyTorch port, with
the flags of ``scripts/sample_diffusion.py``.

    python -m sd_tpu_torch.scripts.sample_diffusion -c sd_tpu_torch/configs/celebahq-ldm-vq-4.yaml \
        -n 8 --batch_size 4 --custom_steps 50 -e 1.0 -l outputs/diffusion-samples
    python -m sd_tpu_torch.scripts.sample_diffusion --tiny --device cpu -n 4

Samples ``-n`` images in batches of ``--batch_size`` by DDIM
(``--custom_steps`` steps at eta ``-e``) or, with ``-v``, the ancestral
chain over every DDPM timestep, decodes them (a VQ first stage through its
codebook), prints each batch's throughput and writes
``<logdir>/img/NNNNNN.png`` and the ADM-style
``<logdir>/<N>-<H>x<W>-samples.npz`` (uint8 ``[N, H, W, 3]`` under
``arr_0``). The model: ``-r``, a reference ``.ckpt`` with ``-c`` its
config, or one of the port's training runs (its EMA shadow unless
``--no_ema``; its own config unless ``-c``); ``-c`` alone samples seeded
random weights; ``--tiny`` the tiny unconditional model (the tiny
class-conditional one with ``--classes``). ``--classes`` (ids cycled over
the samples, or ``random``) conditions on class ids through the cond stage,
with classifier-free guidance at ``--scale`` against ``--uncond_class``
(the cond stage's last id by default). In bf16 on the card (``--device``
defaults to ``cuda``); one generator seeded ``--seed`` draws everything.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("-r", "--resume", type=str,
                   help="a reference .ckpt, or a training run's logdir")
    p.add_argument("-c", "--config", type=str)
    p.add_argument("--no_ema", action="store_true",
                   help="run directories: the current parameters, not the EMA shadow")
    p.add_argument("-n", "--n_samples", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("-e", "--eta", type=float, default=1.0)
    p.add_argument("-v", "--vanilla_sample", action="store_true",
                   help="the ancestral chain over every DDPM timestep instead of DDIM")
    p.add_argument("--custom_steps", type=int, default=50)
    p.add_argument("-l", "--logdir", type=str, default="outputs/diffusion-samples")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--classes", type=str, default=None,
                   help="comma-separated class ids cycled over the samples, or 'random'")
    p.add_argument("--scale", type=float, default=1.0, help="guidance scale with --classes")
    p.add_argument("--uncond_class", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build_model(opt: argparse.Namespace):
    """``(ldm, latent_hw, latent_channels)`` that ``opt`` asks for."""
    from sd_tpu_torch.pipelines.build import inference_dtype
    from sd_tpu_torch.utils import config as C
    from sd_tpu_torch.utils.checkpoint import is_run_path, run_config_path
    from sd_tpu_torch.utils.port import load_torch_state_dict

    device = torch.device(opt.device)
    dtype = inference_dtype(device)
    if opt.tiny:
        model_cfg = (C.tiny_class_cond_model_config() if opt.classes is not None
                     else C.tiny_uncond_model_config())
        return C.build_latent_diffusion(model_cfg, device=device, dtype=dtype,
                                        seed=opt.seed), 16, 4
    if opt.resume and is_run_path(opt.resume):
        ldm, _ = C.build_latent_diffusion_from_run(opt.resume, opt.config, device=device,
                                                   dtype=dtype, use_ema=not opt.no_ema)
        cfg = C.load_yaml(opt.config or run_config_path(opt.resume))
    else:
        if not opt.config:
            raise SystemExit("-c/--config is required unless -r names a run directory or "
                             "--tiny is given")
        cfg = C.load_yaml(opt.config)
        state_dict = None
        if opt.resume:
            state_dict = load_torch_state_dict(opt.resume)
        else:
            print("WARNING: no checkpoint (-r) given: sampling random weights", file=sys.stderr)
        ldm = C.build_latent_diffusion(cfg["model"] if "model" in cfg else cfg, device=device,
                                       dtype=dtype, seed=opt.seed, state_dict=state_dict)
    params = (cfg["model"] if "model" in cfg else cfg)["params"]
    return ldm, params.get("image_size", 64), params.get("channels", 4)


@torch.inference_mode()
def sample(ldm, latent_hw: int, latent_channels: int, opt: argparse.Namespace) -> dict:
    """Samples and writes what ``opt`` asks for. Returns the latents
    ``[N, C, h, w]`` (float32), the uint8 images, the ``.npz`` path and each
    batch's samples/s."""
    from sd_tpu_torch.samplers.ancestral import p_sample_loop
    from sd_tpu_torch.samplers.ddim import ddim_sample
    from sd_tpu_torch.utils.image import save_image

    device = next(ldm.parameters()).device
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    img_dir = os.path.join(opt.logdir, "img")
    os.makedirs(img_dir, exist_ok=True)
    class_ids = uncond_id = None
    if opt.classes is not None:
        n_classes = ldm.cond_stage_model.embedding.num_embeddings
        if opt.classes == "random":
            class_ids = torch.randint(0, min(n_classes, 1000), (opt.n_samples,),
                                      generator=generator, device=device).cpu().numpy()
        else:
            class_ids = np.resize(np.asarray([int(c) for c in opt.classes.split(",")]),
                                  opt.n_samples)
        uncond_id = opt.uncond_class if opt.uncond_class is not None else n_classes - 1

    latents, images, rates = [], [], []
    n_saved = 0
    while n_saved < opt.n_samples:
        b = min(opt.batch_size, opt.n_samples - n_saved)
        cond = uncond = None
        scale = 1.0
        if class_ids is not None:
            ids = torch.as_tensor(class_ids[n_saved:n_saved + b], device=device).long()
            cond = ldm.get_learned_conditioning(ids)
            if opt.scale != 1.0:
                uncond = ldm.get_learned_conditioning(torch.full_like(ids, uncond_id))
                scale = opt.scale
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        shape = (b, latent_channels, latent_hw, latent_hw)
        if opt.vanilla_sample:
            z = p_sample_loop(ldm.apply_model, ldm.schedule, shape, cond, generator,
                              uncond=uncond, guidance_scale=scale)
        else:
            x_T = torch.randn(shape, generator=generator, device=device)
            z = ddim_sample(ldm.apply_model, ldm.schedule, x_T, cond,
                            num_steps=opt.custom_steps, eta=opt.eta, uncond=uncond,
                            guidance_scale=scale, generator=generator)
        x = torch.clamp((ldm.decode_first_stage(z).float() + 1.0) / 2.0, 0.0, 1.0)
        u8 = (x.permute(0, 2, 3, 1).cpu().numpy() * 255.0 + 0.5).astype(np.uint8)
        rates.append(b / (time.perf_counter() - t0))
        print(f"Throughput for this batch: {rates[-1]:.4f} samples/sec")
        for img in u8:
            save_image(img, os.path.join(img_dir, f"{n_saved:06}.png"))
            n_saved += 1
        latents.append(z.float())
        images.append(u8)
    arr = np.concatenate(images)
    npz = os.path.join(opt.logdir, f"{arr.shape[0]}-{arr.shape[1]}x{arr.shape[2]}-samples.npz")
    np.savez(npz, arr)
    print(f"Saved {n_saved} samples -> {npz}")
    return {"latents": torch.cat(latents), "images": arr, "npz": npz, "samples_per_s": rates}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Runs the CLI; returns :func:`sample`'s result."""
    opt = parse_args(argv)
    if torch.device(opt.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    ldm, hw, channels = build_model(opt)
    return sample(ldm, hw, channels, opt)


if __name__ == "__main__":
    main()
