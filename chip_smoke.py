#!/usr/bin/env python3
"""Drive the PyTorch port's txt2img path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the exit code is not 0:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds sd_tpu_torch/csrc into build/sd_tpu_torch (git-ignored);
3. K1 flash attention and 4. K2 GEGLU feed-forward: each kernel against its
   plain PyTorch version at every shape of the SD v1 path at batch 1 with
   guidance (B=2), bf16 inputs, the plain version computed in fp32 from the
   same inputs; max abs error and the ms of each (CUDA events);
5. reference: the tiny model in bf16 on the card against the same weights in
   fp32 on the CPU (plain versions), 5 PLMS steps, latents compared;
6. main path: SD v1 at full width (860M UNet, kl-f8 decoder, CLIP ViT-L/14
   text tower) with seeded random weights in bf16 serves three one-prompt
   requests at 512x512, PLMS 50 steps, guidance 7.5, through
   Txt2ImgPipeline.__call__; the launch counters, reset just before, must
   show K1 = 16 (S+1) + 1 and K2 = 16 (S+1) per request.

The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Without CUDA it fails before printing either.
"""

import copy
import json
import subprocess
import time

import numpy as np
import torch

STEPS = 50
REQUESTS = 3
PROMPT = "a painting of a virus monster playing guitar"
SITES_PER_UNET = 16  # SpatialTransformer blocks of the SD v1 UNet

# (B, N, H, D): the UNet's self-attention sites at 64x64, 32x32, 16x16 and
# 8x8 latents, and the VAE mid-block, at batch 1 with guidance
FLASH_SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160), (2, 64, 8, 160),
                (1, 4096, 1, 512)]
# (M, C, inner): the transformer FF blocks, M = 2 * tokens
FF_SHAPES = [(8192, 320, 1280), (2048, 640, 2560), (512, 1280, 5120), (128, 1280, 5120)]
# bf16 rounds to 8 mantissa bits (2^-9 relative) at P or h and at the output;
# the error bound is 2e-2 of the output's scale: max |plain| for K1, whose
# outputs are averages well below 1 at N=4096, and max(1, max |plain|) for K2
KERNEL_TOL = 2e-2
# tiny model, bf16 on the card vs fp32 on the CPU after 6 UNet calls with
# guidance 7.5: max |diff| of the latents over max |fp32 latents|
REFERENCE_TOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def check_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script "
                         "runs on the card only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {name}, {torch.cuda.device_count()} visible; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)
    return name


def build() -> None:
    from sd_tpu_torch.ops.cuda import _build

    info = _build.build_info()
    _build.kernels()
    log(f"[build] {info['path']} in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name: str, shape, kernel_fn, plain_fn, fp32_args, bf16_args,
            scale_floor: float) -> dict:
    out = kernel_fn(*bf16_args)
    torch.cuda.synchronize()
    ref = plain_fn(*fp32_args)
    err = (out.float() - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    bound = KERNEL_TOL * max(scale_floor, ref_max)
    ms = time_ms(lambda: kernel_fn(*bf16_args))
    plain_ms = time_ms(lambda: plain_fn(*bf16_args))
    ok = np.isfinite(err) and err <= bound
    log(f"[{name}] {shape}: max_abs_err {err:.3e} (max |plain| {ref_max:.3e}, bound "
        f"{bound:.3e}) kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} at {shape}: max abs error {err} above {bound}")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


def check_kernels() -> dict:
    from sd_tpu_torch.ops.cuda import (flash_attention, flash_attention_plain, geglu_ff,
                                       geglu_ff_plain)

    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    results = {"flash_attention": [], "geglu_ff": []}
    for shape in FLASH_SHAPES:
        qkv = [randn(*shape) for _ in range(3)]
        bf = [t.to(torch.bfloat16) for t in qkv]
        results["flash_attention"].append(compare(
            "K1 flash_attention", shape, flash_attention, flash_attention_plain,
            [t.float() for t in bf], bf, scale_floor=0.0))
    for m, c, inner in FF_SHAPES:
        args = [randn(m, c), randn(2 * inner, c) * c**-0.5, 0.1 * randn(2 * inner),
                randn(c, inner) * inner**-0.5, 0.1 * randn(c)]
        bf = [a.to(torch.bfloat16) if a.ndim == 2 else a for a in args]
        results["geglu_ff"].append(compare(
            "K2 geglu_ff", (m, c, inner), geglu_ff, geglu_ff_plain,
            [a.float() for a in bf], bf, scale_floor=1.0))
    return results


def check_reference() -> None:
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.pipelines.txt2img import Txt2ImgPipeline

    cpu_pipe, hw = build_txt2img_pipeline(tiny=True, device="cpu", seed=0, watermark=False)
    card_ldm = copy.deepcopy(cpu_pipe.ldm).to(device="cuda", dtype=torch.bfloat16)
    card_pipe = Txt2ImgPipeline(ldm=card_ldm, tokenizer=cpu_pipe.tokenizer,
                                downsample=cpu_pipe.downsample)
    x_T = np.random.default_rng(0).standard_normal((2, hw // 2, hw // 2, 4)).astype(np.float32)
    run = dict(height=hw, width=hw, steps=5, guidance_scale=7.5)
    prompts = [PROMPT, "a red cube"]
    cpu_pipe(prompts, x_T=torch.from_numpy(x_T), **run)
    card_pipe(prompts, x_T=torch.from_numpy(x_T).cuda(), **run)
    want = cpu_pipe.last_latents
    got = card_pipe.last_latents.cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[reference] tiny model, bf16 card vs fp32 CPU, PLMS 5: max |diff| / max |ref| "
        f"= {rel:.3e} (bound {REFERENCE_TOL})")
    if not (np.isfinite(rel) and rel <= REFERENCE_TOL):
        raise AssertionError(f"tiny model disagrees with its fp32 CPU reference: {rel}")


def serve_main_path() -> dict:
    from sd_tpu_torch.ops.cuda import flash_attention, geglu_ff
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline

    t0 = time.perf_counter()
    pipe, _ = build_txt2img_pipeline(device="cuda", seed=0, watermark=False)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.ldm.parameters())
    log(f"[main] SD v1 full width, {n_params / 1e6:.1f}M parameters in bf16, built in "
        f"{time.perf_counter() - t0:.1f} s; {REQUESTS} requests, 512x512, PLMS {STEPS} steps, "
        f"guidance 7.5 (no cut)")
    flash_attention.launches = 0
    geglu_ff.launches = 0
    for r in range(REQUESTS):
        gen = torch.Generator(device="cuda").manual_seed(r)
        images = pipe([PROMPT], gen, height=512, width=512, steps=STEPS, guidance_scale=7.5)
        t = pipe.last_timings
        z = pipe.last_latents
        log(f"[main] request {r}: {t['total_s']:.3f} s (encode {t['encode_s']:.3f}, sample "
            f"{t['sample_s']:.3f}, decode {t['decode_s']:.3f}); "
            f"{t['sample_s'] * 1e3 / (STEPS + 1):.2f} ms per UNet evaluation (B=2)")
        if images.shape != (1, 512, 512, 3) or images.dtype != np.uint8:
            raise AssertionError(f"request {r}: images {images.shape} {images.dtype}")
        if images.min() == images.max():
            raise AssertionError(f"request {r}: constant image")
        if not torch.isfinite(z).all():
            raise AssertionError(f"request {r}: latents not finite")
    launches = {"flash_attention": flash_attention.launches, "geglu_ff": geglu_ff.launches}
    want = {"flash_attention": REQUESTS * (SITES_PER_UNET * (STEPS + 1) + 1),
            "geglu_ff": REQUESTS * SITES_PER_UNET * (STEPS + 1)}
    log(f"[main] launches {launches}, expected {want}")
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    return launches


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = check_device()
    build()
    timings = check_kernels()
    check_reference()
    launches = serve_main_path()
    source = {"flash_attention": ("sd_tpu_torch/csrc/flash_attention.cu",
                                  "sd_tpu/ops/pallas/flash_attention.py:324"),
              "geglu_ff": ("sd_tpu_torch/csrc/geglu_ff.cu",
                           "sd_tpu/ops/pallas/geglu_ff.py:255")}
    kernels = [{"name": k, "route": "cuda", "source": source[k][0], "replaces": source[k][1],
                "launches": launches[k],
                "max_abs_err": max(r["err"] for r in rs),
                "ms": sum(r["ms"] for r in rs), "plain_ms": sum(r["plain_ms"] for r in rs)}
               for k, rs in timings.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
