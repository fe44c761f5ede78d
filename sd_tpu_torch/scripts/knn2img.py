"""Retrieval-augmented sampling (RDM, knn2img) of the PyTorch port, with the
flags of ``scripts/knn2img.py``.

    python -m sd_tpu_torch.scripts.knn2img --prompt "a happy bear reading a newspaper" \
        --database index.npz --use_neighbors --knn 4 --n_samples 4 --ddim_steps 50 --scale 5.0
    python -m sd_tpu_torch.scripts.knn2img --tiny --device cpu --database index.npz \
        --use_neighbors --knn 2 --ddim_steps 5

The prompt's CLIP text embedding is the query; with ``--use_neighbors`` its
``--knn`` nearest embeddings in ``--database`` (an index written by
``train_searcher``) follow it in the cross-attention context, else the
query alone is the context. The unconditional context is zeros, and the
sampler (DDIM at eta 0, or ``--plms``) guides at ``--scale``. Writes
``<outdir>/NNNNN.png``.

The model: ``--config`` (the 768² RDM's by default,
``sd_tpu_torch/configs/retrieval-augmented-diffusion-768x768.yaml``; f = 16,
16 latent channels) with seeded random weights, or ``--ckpt`` a reference
checkpoint, which needs CLIP's BPE vocabulary (``SD_TPU_BPE_VOCAB``); the
query comes from the ViT-L/14 text tower with its projection, from seeded
weights, over the hash tokenizer. ``--tiny``: the tiny crossattn model
(context 24, f = 2, 32² images) with a seeded random projection standing
in for the text encoder. In bf16 on the card (``--device`` defaults to
``cuda``; a run that asks for the card and finds none fails); one generator
seeded ``--seed`` draws the starting noise. The search runs on the same
device.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

RDM_CONFIG = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                          "retrieval-augmented-diffusion-768x768.yaml")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--prompt", type=str, default="a happy bear reading a newspaper")
    p.add_argument("--outdir", type=str, default="outputs/knn2img-samples")
    p.add_argument("--ddim_steps", type=int, default=50)
    p.add_argument("--plms", action="store_true")
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--scale", type=float, default=5.0)
    p.add_argument("--knn", type=int, default=10)
    p.add_argument("--database", type=str, help="npz index (train_searcher) path")
    p.add_argument("--use_neighbors", action="store_true")
    p.add_argument("--config", type=str, default=RDM_CONFIG)
    p.add_argument("--ckpt", type=str)
    p.add_argument("--H", type=int, default=768)
    p.add_argument("--W", type=int, default=768)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def _prompt_seed(prompts: Sequence[str]) -> int:
    """A seed from the prompts that is the same in every process."""
    return int(hashlib.md5("\n".join(prompts).encode()).hexdigest(), 16) % 2**31


def build_model(opt: argparse.Namespace):
    """``(ldm, encode_text, downsample, latent_channels)`` that ``opt`` asks
    for; ``encode_text(prompts)`` gives the fp32 queries ``[B, D]`` on the
    CPU. ``--tiny`` sets ``opt.H = opt.W = 32``."""
    from sd_tpu_torch.models.clip import CLIP_VIT_L_14_TEXT, CLIPTextModelWithProjection
    from sd_tpu_torch.pipelines.build import inference_dtype
    from sd_tpu_torch.utils import config as C

    device = torch.device(opt.device)
    dtype = inference_dtype(device)
    if opt.tiny:
        cfg = C.tiny_knn_model_config()
        ldm = C.build_latent_diffusion(cfg, device=device, dtype=dtype, seed=opt.seed)
        opt.H = opt.W = 32

        def encode_text(prompts):  # a seeded random projection stands in for the text tower
            g = torch.Generator().manual_seed(_prompt_seed(prompts))
            return torch.randn((len(prompts), 24), generator=g)

        return ldm, encode_text, 2, 4
    from sd_tpu_torch.data.tokenizer import HashTokenizer
    from sd_tpu_torch.utils.port import load_torch_state_dict

    state_dict = None
    if opt.ckpt:
        if not os.environ.get("SD_TPU_BPE_VOCAB"):
            # the hash tokenizer's ids would index a real text tower at random
            raise SystemExit(
                "--ckpt loads a real checkpoint but no BPE vocab is configured: set "
                "SD_TPU_BPE_VOCAB to the CLIP merges file (bpe_simple_vocab_16e6.txt.gz). The "
                "hash tokenizer is only valid for random-weight runs.")
        state_dict = load_torch_state_dict(opt.ckpt)
    cfg = C.load_yaml(opt.config)
    ldm = C.build_latent_diffusion(cfg["model"], device=device, dtype=dtype, seed=opt.seed,
                                   state_dict=state_dict)
    with torch.device("meta"):
        tower = CLIPTextModelWithProjection(CLIP_VIT_L_14_TEXT)
    tower.to_empty(device=device)
    C.init_random_(tower, torch.Generator(device=device).manual_seed(opt.seed))
    tower.to(dtype).eval()
    tok = HashTokenizer()

    @torch.inference_mode()
    def encode_text(prompts):
        ids = torch.from_numpy(tok(list(prompts)).astype(np.int64)).to(device)
        return tower(ids).float().cpu()

    # the RDM is an f16 model with 16 latent channels
    return ldm, encode_text, 16, 16


def conditioning(q: torch.Tensor, opt: argparse.Namespace):
    """``(cond, uncond)`` ``[B, 1 (+ k), D]`` for the queries ``q``."""
    from sd_tpu_torch.pipelines.retrieval import Searcher, knn_conditioning

    if opt.use_neighbors:
        if not opt.database:
            raise SystemExit("--use_neighbors requires --database")
        return knn_conditioning(q, Searcher(opt.database, device=opt.device), k=opt.knn)
    cond = q[:, None, :]
    return cond, torch.zeros_like(cond)


@torch.inference_mode()
def sample(ldm, cond: torch.Tensor, uncond: torch.Tensor, downsample: int, channels: int,
           opt: argparse.Namespace) -> torch.Tensor:
    """The sampler's latents ``[B, C, H / f, W / f]`` from the generator's
    x_T, guided at ``opt.scale``."""
    from sd_tpu_torch.samplers.ddim import ddim_sample
    from sd_tpu_torch.samplers.plms import plms_sample

    device = next(ldm.parameters()).device
    dtype = next(ldm.model.parameters()).dtype
    generator = torch.Generator(device=device).manual_seed(opt.seed)
    shape = (cond.shape[0], channels, opt.H // downsample, opt.W // downsample)
    x_T = torch.randn(shape, generator=generator, device=device).to(dtype)
    sampler = plms_sample if opt.plms else ddim_sample
    return sampler(ldm.apply_model, ldm.schedule, x_T, cond.to(device, dtype),
                   num_steps=opt.ddim_steps, uncond=uncond.to(device, dtype),
                   guidance_scale=opt.scale)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns the latents, the paths written and samples/s of the sampling
    and decoding (the model's build and the search excluded)."""
    opt = parse_args(argv)
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    from sd_tpu_torch.utils.image import save_image

    ldm, encode_text, downsample, channels = build_model(opt)
    prompts = [opt.prompt] * opt.n_samples
    cond, uncond = conditioning(encode_text(prompts), opt)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    z = sample(ldm, cond, uncond, downsample, channels, opt)
    with torch.inference_mode():
        x = ldm.decode_first_stage(z)
        x = torch.clamp((x.float() + 1.0) / 2.0, 0.0, 1.0)
        imgs = (x * 255 + 0.5).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    sync()
    seconds = time.perf_counter() - t0
    os.makedirs(opt.outdir, exist_ok=True)
    paths = []
    for i, img in enumerate(imgs):
        paths.append(os.path.join(opt.outdir, f"{i:05}.png"))
        save_image(img, paths[-1])
    rate = len(imgs) / seconds
    print(f"Saved {len(imgs)} samples to {opt.outdir} ({rate:.4f} samples/s, "
          f"{'PLMS' if opt.plms else 'DDIM'} {opt.ddim_steps}, context {tuple(cond.shape)})")
    return {"latents": z, "paths": paths, "samples_per_s": rate, "cond": cond}


if __name__ == "__main__":
    main()
