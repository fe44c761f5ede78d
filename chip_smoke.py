#!/usr/bin/env python3
"""Drive the PyTorch port's three main paths once on one NVIDIA card: txt2img
serving in bf16 and in the int8 serving mode, and LDM training, all at SD v1
full width.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the exit code is not 0:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds sd_tpu_torch/csrc into build/sd_tpu_torch (git-ignored);
3. K1 flash attention and 4. K2 GEGLU feed-forward: each kernel against its
   plain PyTorch version at every shape of the serving path at batch 1 with
   guidance (B=2) and of the training path at batch 4, bf16 inputs, the
   plain version computed in fp32 from the same inputs; K1's row log-sum-exp (the statistic K3 reads) against its
   plain version too; max abs error and the ms of each (CUDA events), the
   bound, and the ms of one PyTorch call computing the same function
   (scaled_dot_product_attention for K1; none for K2);
5. K3 flash-attention backward: at the training path's two shapes, dQ, dK
   and dV from K1 + K3 against the plain backward in fp32 on the same bf16
   inputs; the yardstick is scaled_dot_product_attention's forward+backward
   minus its forward;
6. reference: the tiny model in bf16 on the card against the same weights in
   fp32 on the CPU (plain versions), 5 PLMS steps, latents compared;
7. serving: SD v1 at full width (860M UNet, kl-f8 decoder, CLIP ViT-L/14
   text tower) with seeded random weights in bf16 serves three one-prompt
   requests at 512x512, PLMS 50 steps, guidance 7.5, through
   Txt2ImgPipeline.__call__; the launch counters, reset just before, must
   show K1 = 16 (S+1) + 1 and K2 = 16 (S+1) per request;
8. training reference: the tiny model at 128² images (64x64 latents, so its
   attention sites have N=1024 and take K3), one loss and its UNet gradients
   in bf16 autocast on the card against fp32 on the CPU with the same
   weights, batch, t and noise, each within its stated bound; then 20
   constant-LR steps on one fixed batch on the card, whose loss must fall;
9. training: SD v1 at full width (fp32 master weights and AdamW moments,
   bf16 autocast; frozen kl-f8 encoder and CLIP in bf16; use_checkpoint on),
   batch 4 of 512² synthetic images with 77-token captions, 5 steps through
   Trainer.fit as `python -m sd_tpu_torch.scripts.train` builds it. Every
   step: a finite loss, a finite non-zero gradient on every UNet parameter,
   and exactly K1 = 16 + 16 + 1, K2 = 32 and K3 = 10 launches; at the end,
   non-zero AdamW moments on every parameter, and the time and size of
   the checkpoint that fit saves on exit (in a temporary directory);
10. K4 int8 GEGLU-FF, K5 int8 attention ("qk" and "qkpv") and K6 int8
   dense: each kernel against its plain PyTorch version (fp32 on the same
   bf16 inputs, the same int8 codes) at every shape of the int8 serving
   path at batch 1 and batch 8, with the ms of the bf16 path the site takes
   otherwise (K2, K1, F.linear); each kernel within its own bound
   (INT8_TOL), which the bf16 path's output (and, for K5 "qkpv", K5 "qk"'s)
   must exceed at every shape, so that a kernel skipping its quantization
   fails;
11. int8 reference: the tiny model at 256² (attention at N=4096, the
   decoder's at N=16384) with every bucket in bf16 on the card against the
   same weights in fp32 on the CPU without int8, PLMS 5: relative L2 of the
   latents within the int8 agreement bound, and not identical to the
   card's bf16 run;
12. int8 serving: SD v1 with SD_TPU_INT8's "all" serves three requests with
   the bf16 phase's generators; per request K5 = 5 (S+1) + 1, K1 = 11 (S+1),
   K4 = 5 (S+1), K2 = 11 (S+1), K6 = 0 and one int8 conv per Conv3x3 call;
   request 0's latents within relative L2 0.10 of the bf16 request 0 and not
   identical (tools/int8_quality.py's flagship gate); then one request with
   every bucket (K6 = 64 (S+1), the decoder's K5 in "qkpv"); then one
   request at batch 8 (K4 = 11 (S+1)), its images/s beside a bf16 batch-8
   request.

The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Without CUDA it fails before printing either.
"""

import copy
import gc
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

STEPS = 50
REQUESTS = 3
TRAIN_STEPS = 5
PROMPT = "a painting of a virus monster playing guitar"
SITES_PER_UNET = 16  # SpatialTransformer blocks of the SD v1 UNet

# (B, N, H, D): the UNet's self-attention sites at 64x64, 32x32, 16x16 and
# 8x8 latents, and the VAE mid-block: serving at batch 1 with guidance (B=2;
# the decoder's mid-block at B=1), then training at batch 4 (the encoder's)
FLASH_SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160), (2, 64, 8, 160),
                (1, 4096, 1, 512),
                (4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160), (4, 64, 8, 160),
                (4, 4096, 1, 512)]
# (M, C, inner): the transformer FF blocks, M = B * tokens, serving then training
FF_SHAPES = [(8192, 320, 1280), (2048, 640, 2560), (512, 1280, 5120), (128, 1280, 5120),
             (16384, 320, 1280), (4096, 640, 2560), (1024, 1280, 5120), (256, 1280, 5120)]
# (B, N, H, D): the training sites that take K3 (N > 256) at batch 4
BWD_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80)]
# bf16 rounds to 8 mantissa bits (2^-9 relative) at P or h, at dS and at the
# outputs; the error bound is 2e-2 of the output's scale: max |plain| for K1
# and K3, whose outputs are well below 1, and max(1, max |plain|) for K2
KERNEL_TOL = 2e-2
# K1's log-sum-exp is fp32 throughout: absolute bound in log2 units
LSE_TOL = 1e-3
# tiny model, bf16 on the card vs fp32 on the CPU after 6 UNet calls with
# guidance 7.5: max |diff| of the latents over max |fp32 latents|
REFERENCE_TOL = 5e-2
# tiny training step, bf16 autocast on the card vs fp32 on the CPU: the loss
# (relative), all UNet gradients together (relative L2), and each tensor's
# gradient: |diff| <= 0.25 |ref| + 1e-4 |all ref| (L2 norms), so a tensor that
# gets no gradient on the card fails unless its reference gradient is itself
# negligible. The tiny UNet's GroupNorm groups hold one channel each at its
# first level, which cancels the per-channel timestep shift there: those
# emb_layers have a zero gradient in exact arithmetic and only rounding noise
# on either device.
TRAIN_LOSS_TOL = 2e-2
TRAIN_GRAD_TOL = 5e-2
TRAIN_TENSOR_TOL = 0.25
TRAIN_TENSOR_FLOOR = 1e-4
# per training step of SD v1 with use_checkpoint: 16 UNet sites forward, the
# same 16 again when checkpointing recomputes them in the backward, and the
# VAE encoder's mid-block; K3 at the five N=4096 and five N=1024 sites
TRAIN_LAUNCHES = {"flash_attention": 2 * SITES_PER_UNET + 1, "geglu_ff": 2 * SITES_PER_UNET,
                  "flash_attention_bwd": 10}

# the H100 SXM's dense bf16 and int8 tensor-core rates and memory rate
PEAK_FLOPS = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

# the int8 serving path. (M, C, inner): the FF sites K4 takes, batch 1 (B=2)
# then batch 8 (B=16)
INT8_FF_SHAPES = [(2048, 640, 2560), (16384, 640, 2560), (4096, 1280, 5120),
                  (1024, 1280, 5120)]
# (B, N, H, D, mode): the UNet's N=4096 sites and the decoder's mid-block
INT8_FLASH_SHAPES = [(2, 4096, 8, 40, "qk"), (16, 4096, 8, 40, "qk"), (1, 4096, 1, 512, "qk"),
                     (1, 4096, 1, 512, "qkpv"), (8, 4096, 1, 512, "qk")]
# (M, C, F): the proj bucket's self-attention QKV (F = 3C), cross q and
# to_out (F = C), batch 1 then batch 8
INT8_DENSE_SHAPES = [(b * n, c, f * c) for b in (2, 16)
                     for n, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))
                     for f in (3, 1)]
# the flagship agreement gate of tools/int8_quality.py: int8 against bf16
# latents after the whole trajectory, relative L2
AGREEMENT_TOL = 0.10
BATCH8 = 8
# The int8 kernels' max abs error bounds, as fractions of the output's scale
# (max |plain|, at least 1 for K4 and K6), each set between the kernel's
# reading and that of the same inputs through the bf16 path without the
# quantization (K2, K1, F.linear; K5 "qk" for "qkpv"). On an H100 80GB HBM3
# at 700 W the sound kernels read at most 9.2e-3 (K4), 3.3e-3 (K5 "qk"),
# 1.2e-2 (K5 "qkpv") and 3.5e-3 (K6); the bf16 paths at least 3.3e-2,
# 1.3e-2, 1.1e-1 and 1.0e-2. Every run asserts that each bf16 path would
# fail its kernel's bound, so that a kernel that skipped its quantization
# cannot pass; KERNEL_TOL (2e-2) would pass one at K5 "qk"'s shapes.
INT8_TOL = {"K4": 1.6e-2, "K5 qk": 6e-3, "K5 qkpv": 2e-2, "K6": 6e-3}


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
    lines = [line.strip() for line in info["log"].splitlines()]
    used = [line for line in lines if "Used" in line]
    spills = [line for line in lines if "spill" in line and not line.startswith("0 bytes")]
    log(f"[build] {info['path']} in {info['seconds']:.1f} s: {len(used)} kernels, "
        f"{len(spills)} with register spills")
    for line in spills:
        log(f"[build]   {line}")


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


def bound(flops: float, nbytes: float, int8_ops: float = 0.0) -> dict:
    """The least time of the work on this card: the bf16 operations over the
    bf16 peak plus the int8 operations over the int8 peak, or the bytes over
    the memory rate, whichever is larger."""
    ops_ms = (flops / PEAK_FLOPS + int8_ops / PEAK_INT8) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def check_error(name: str, shape, got: torch.Tensor, ref: torch.Tensor,
                scale_floor: float = 0.0, tol: float = KERNEL_TOL) -> float:
    err = (got.float() - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    limit = tol * max(scale_floor, ref_max)
    ok = np.isfinite(err) and err <= limit
    log(f"[{name}] {shape}: max_abs_err {err:.3e} (max |plain| {ref_max:.3e}, bound "
        f"{limit:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} at {shape}: max abs error {err} above {limit}")
    return err


def check_int8_error(name: str, shape, got: torch.Tensor, ref: torch.Tensor, unquantized: dict,
                     scale_floor: float = 0.0) -> float:
    """check_error within INT8_TOL[name], and each output in ``unquantized``
    (label: the same inputs through a path without the quantization) outside
    that bound."""
    tol = INT8_TOL[name]
    err = check_error(name, shape, got, ref, scale_floor, tol)
    scale = max(scale_floor, ref.abs().max().item())
    for label, other in unquantized.items():
        other_err = (other.float() - ref).abs().max().item()
        ok = np.isfinite(other_err) and other_err > tol * scale
        log(f"[{name}] {shape}: max abs error {err / scale:.3e} of the scale (bound {tol}); "
            f"{label} without int8 {other_err / scale:.3e}, "
            f"{'outside the bound, ok' if ok else 'INSIDE THE BOUND, FAIL'}")
        if not ok:
            raise AssertionError(f"{name} at {shape}: {label} without int8 reads {other_err}, "
                                 f"within the bound {tol * scale}: the check cannot tell them "
                                 f"apart")
    return err


def sdpa(q, k, v, scale):
    """The library yardstick on the token-major [B, N, H, D] inputs."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), scale=scale)


def check_flash(randn) -> list:
    from sd_tpu_torch.ops.cuda import (flash_attention, flash_attention_lse_plain,
                                       flash_attention_plain)
    from sd_tpu_torch.ops.cuda.flash_attention import _launch_forward

    rows = []
    for shape in FLASH_SHAPES:
        b, n, h, d = shape
        scale = d**-0.5
        bf = [randn(*shape).to(torch.bfloat16) for _ in range(3)]
        fp = [t.float() for t in bf]
        out = flash_attention(*bf, scale)
        # the log-sum-exp that only the autograd path asks K1 for
        lse = _launch_forward(*bf, scale, with_lse=True)[1]
        torch.cuda.synchronize()
        err = check_error("K1 flash_attention", shape, out, flash_attention_plain(*fp, scale))
        lse_err = (lse - flash_attention_lse_plain(fp[0], fp[1], scale)).abs().max().item()
        log(f"[K1 flash_attention] {shape}: log-sum-exp max_abs_err {lse_err:.3e} (bound "
            f"{LSE_TOL})")
        if not (np.isfinite(lse_err) and lse_err <= LSE_TOL):
            raise AssertionError(f"K1 log-sum-exp at {shape}: {lse_err}")
        ms = time_ms(lambda: flash_attention(*bf, scale))
        plain_ms = time_ms(lambda: flash_attention_plain(*bf, scale))
        library_ms = time_ms(lambda: sdpa(*bf, scale))
        bnd = bound(4 * b * h * n * n * d, 4 * b * n * h * d * 2)
        log(f"[K1 flash_attention] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa {library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bnd))
    return rows


def check_geglu(randn) -> list:
    from sd_tpu_torch.ops.cuda import geglu_ff, geglu_ff_plain

    rows = []
    for m, c, inner in FF_SHAPES:
        args = [randn(m, c), randn(2 * inner, c) * c**-0.5, 0.1 * randn(2 * inner),
                randn(c, inner) * inner**-0.5, 0.1 * randn(c)]
        bf = [a.to(torch.bfloat16) if a.ndim == 2 else a for a in args]
        out = geglu_ff(*bf)
        torch.cuda.synchronize()
        err = check_error("K2 geglu_ff", (m, c, inner), out,
                          geglu_ff_plain(*[a.float() for a in bf]), scale_floor=1.0)
        ms = time_ms(lambda: geglu_ff(*bf))
        plain_ms = time_ms(lambda: geglu_ff_plain(*bf))
        nbytes = (2 * m * c + 3 * inner * c) * 2 + (2 * inner + c) * 4 + m * c * 2
        bnd = bound(6 * m * c * inner, nbytes)
        log(f"[K2 geglu_ff] {(m, c, inner)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **bnd))
    return rows


def check_flash_bwd(randn) -> list:
    from sd_tpu_torch.ops.cuda import (differentiable_flash_attention, flash_attention_bwd,
                                       flash_attention_bwd_plain, flash_attention_plain)
    from sd_tpu_torch.ops.cuda.flash_attention import _launch_forward

    rows = []
    for shape in BWD_SHAPES:
        b, n, h, d = shape
        scale = d**-0.5
        q, k, v = (randn(*shape).to(torch.bfloat16).requires_grad_() for _ in range(3))
        do = randn(*shape).to(torch.bfloat16)
        o = differentiable_flash_attention(q, k, v, scale)
        torch.cuda.synchronize()
        check_error("K1 differentiable_flash_attention", shape, o,
                    flash_attention_plain(*(t.detach().float() for t in (q, k, v)), scale))
        grads = torch.autograd.grad(o, (q, k, v), do)
        torch.cuda.synchronize()
        q, k, v, o = (t.detach() for t in (q, k, v, o))
        refs = flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o, do)), scale)
        err = max(check_error(f"K3 flash_attention_bwd d{name}", shape, g, r)
                  for name, g, r in zip("QKV", grads, refs))
        lse = _launch_forward(q, k, v, scale, with_lse=True)[1]
        ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, do, lse, scale))
        plain_ms = time_ms(lambda: flash_attention_bwd_plain(q, k, v, o, do, scale))
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(*leaves, scale), leaves, do.transpose(1, 2))

        with torch.no_grad():
            fwd_ms = time_ms(lambda: sdpa(*leaves, scale))
        library_ms = time_ms(sdpa_fwd_bwd) - fwd_ms
        bnd = bound(10 * b * h * n * n * d, 8 * b * n * h * d * 2 + b * h * n * 4)
        log(f"[K3 flash_attention_bwd] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"sdpa fwd+bwd minus fwd {library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
            f"({bnd['bound_by']})")
        rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bnd))
    return rows


def check_int8_ff(randn) -> list:
    from sd_tpu_torch.ops.cuda import geglu_ff, geglu_ff_int8, geglu_ff_int8_plain
    from sd_tpu_torch.ops.cuda.geglu_ff import quantize_ff_weights

    rows = []
    for m, c, inner in INT8_FF_SHAPES:
        x = randn(m, c).to(torch.bfloat16)
        w1 = (randn(2 * inner, c) * c**-0.5).to(torch.bfloat16)
        w2 = (randn(c, inner) * inner**-0.5).to(torch.bfloat16)
        b1, b2 = 0.1 * randn(2 * inner), 0.1 * randn(c)
        qw = quantize_ff_weights(w1, w2, torch.bfloat16)
        out = geglu_ff_int8(x, w1, b1, w2, b2, qw)
        torch.cuda.synchronize()
        err = check_int8_error("K4", (m, c, inner), out,
                               geglu_ff_int8_plain(x.float(), qw, b1, b2),
                               {"K2": geglu_ff(x, w1, b1, w2, b2)}, scale_floor=1.0)
        ms = time_ms(lambda: geglu_ff_int8(x, w1, b1, w2, b2, qw))
        plain_ms = time_ms(lambda: geglu_ff_int8_plain(x, qw, b1, b2))
        bf16_ms = time_ms(lambda: geglu_ff(x, w1, b1, w2, b2))
        nbytes = 2 * m * c * 2 + 3 * inner * c + (4 * inner + 2 * c) * 4
        bnd = bound(0, nbytes, int8_ops=6 * m * c * inner)
        log(f"[K4 geglu_ff_int8] {(m, c, inner)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bf16 K2 {bf16_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bf16_ms=bf16_ms,
                         **bnd))
    return rows


def check_int8_flash(randn) -> list:
    from sd_tpu_torch.ops.cuda import (flash_attention, flash_attention_int8,
                                       flash_attention_int8_plain)

    rows = []
    for b, n, h, d, mode in INT8_FLASH_SHAPES:
        shape = (b, n, h, d)
        scale = d**-0.5
        bf = [randn(*shape).to(torch.bfloat16) for _ in range(3)]
        out = flash_attention_int8(*bf, scale, mode)
        torch.cuda.synchronize()
        unquantized = {"K1": flash_attention(*bf, scale)}
        if mode == "qkpv":
            unquantized["K5 qk"] = flash_attention_int8(*bf, scale, "qk")
        err = check_int8_error(f"K5 {mode}", shape, out,
                               flash_attention_int8_plain(*[t.float() for t in bf], scale, mode),
                               unquantized)
        ms = time_ms(lambda: flash_attention_int8(*bf, scale, mode))
        plain_ms = time_ms(lambda: flash_attention_int8_plain(*bf, scale, mode), iters=5)
        bf16_ms = time_ms(lambda: flash_attention(*bf, scale))
        library_ms = time_ms(lambda: sdpa(*bf, scale))
        products = 2 * b * h * n * n * d
        bnd = bound(0 if mode == "qkpv" else products, 4 * b * n * h * d * 2,
                    int8_ops=2 * products if mode == "qkpv" else products)
        log(f"[K5 flash_attention_int8 {mode}] {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bf16 K1 {bf16_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bf16_ms=bf16_ms, **bnd))
    return rows


def check_int8_dense(randn) -> list:
    from sd_tpu_torch.ops.cuda import int8_dense, int8_dense_plain
    from sd_tpu_torch.ops.cuda.geglu_ff import quantize_cols

    rows = []
    for m, c, f in INT8_DENSE_SHAPES:
        x = randn(m, c).to(torch.bfloat16)
        w = (randn(f, c) * c**-0.5).to(torch.bfloat16)
        b = 0.1 * randn(f)
        wq, sw = quantize_cols(w)
        out = int8_dense(x, w, b, prequant=(wq, sw))
        torch.cuda.synchronize()
        bf16_b = b.to(torch.bfloat16)
        err = check_int8_error("K6", (m, c, f), out,
                               int8_dense_plain(x.float(), wq, sw, b),
                               {"F.linear": F.linear(x, w, bf16_b)}, scale_floor=1.0)
        ms = time_ms(lambda: int8_dense(x, w, b, prequant=(wq, sw)))
        plain_ms = time_ms(lambda: int8_dense_plain(x, wq, sw, b))
        bf16_ms = time_ms(lambda: F.linear(x, w, bf16_b))
        bnd = bound(0, m * c * 2 + f * c + f * 8 + m * f * 2, int8_ops=2 * m * c * f)
        log(f"[K6 int8_dense] {(m, c, f)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 "
            f"F.linear {bf16_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows.append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bf16_ms=bf16_ms,
                         **bnd))
    return rows


def check_int8_conv(randn) -> None:
    """The int8 conv (stock PyTorch: im2col, torch._int_mm) against its
    float64 plain version on the same codes, at UNet sites of each level and
    the VAE decoder's conv_out (Cout 3, padded to 8), with its ms beside
    cuDNN's bf16 conv."""
    from sd_tpu_torch.ops import quant

    for b, cin, hw, cout in ((2, 320, 64, 320), (2, 640, 32, 640), (2, 1280, 16, 1280),
                             (1, 128, 512, 3)):
        x = randn(b, cin, hw, hw).to(torch.bfloat16)
        w = (randn(cout, cin, 3, 3) * (9 * cin) ** -0.5).to(torch.bfloat16)
        bias = 0.1 * randn(cout)
        kq, sw = quant.quantize_conv_kernel(w)
        out = quant.int8_conv3x3(x, w, bias, (kq, sw))
        torch.cuda.synchronize()
        xq, sx = quant._quantize_tensor(x)
        check_error("int8_conv3x3", (b, cin, hw, hw, cout), out,
                    quant.int8_conv3x3_plain(xq, sx, kq, sw, bias, torch.float32),
                    scale_floor=1.0)
        ms = time_ms(lambda: quant.int8_conv3x3(x, w, bias, (kq, sw)))
        bf16_b = bias.to(torch.bfloat16)
        bf16_ms = time_ms(lambda: F.conv2d(x, w, bf16_b, padding=1))
        log(f"[int8_conv3x3] {(b, cin, hw, hw, cout)}: {ms:.4f} ms, cuDNN bf16 {bf16_ms:.4f} ms")


def check_kernels() -> dict:
    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    return {"flash_attention": check_flash(randn), "geglu_ff": check_geglu(randn),
            "flash_attention_bwd": check_flash_bwd(randn)}


def check_int8_kernels() -> dict:
    g = torch.Generator(device="cuda").manual_seed(1)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    check_int8_conv(randn)
    return {"geglu_ff_int8": check_int8_ff(randn), "flash_attention_int8": check_int8_flash(randn),
            "int8_dense": check_int8_dense(randn)}


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


def _counted():
    """Every launch counter: the six kernels, K5's "qkpv" share, and the
    int8 conv's calls on the card."""
    from sd_tpu_torch.ops import cuda
    from sd_tpu_torch.ops.quant import int8_conv3x3

    return {"flash_attention": cuda.flash_attention, "geglu_ff": cuda.geglu_ff,
            "flash_attention_bwd": cuda.flash_attention_bwd,
            "geglu_ff_int8": cuda.geglu_ff_int8, "flash_attention_int8": cuda.flash_attention_int8,
            "int8_dense": cuda.int8_dense, "int8_conv3x3": int8_conv3x3}


def check_int8_reference() -> None:
    """The tiny model at 256² with every int8 bucket, bf16 on the card,
    against the same weights in fp32 on the CPU without int8."""
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.pipelines.txt2img import Txt2ImgPipeline

    cpu_pipe, _ = build_txt2img_pipeline(tiny=True, device="cpu", seed=0, watermark=False)
    card_ldm = copy.deepcopy(cpu_pipe.ldm).to(device="cuda", dtype=torch.bfloat16)
    card_pipe = Txt2ImgPipeline(ldm=card_ldm, tokenizer=cpu_pipe.tokenizer,
                                downsample=cpu_pipe.downsample)
    hw = 256
    x_T = np.random.default_rng(0).standard_normal((2, hw // 2, hw // 2, 4)).astype(np.float32)
    run = dict(height=hw, width=hw, steps=5, guidance_scale=7.5)
    prompts = [PROMPT, "a red cube"]
    cpu_pipe(prompts, x_T=torch.from_numpy(x_T), **run)
    want = cpu_pipe.last_latents
    card_pipe(prompts, x_T=torch.from_numpy(x_T).cuda(), **run)
    bf16 = card_pipe.last_latents.cpu()
    card_ldm.set_int8_mode("conv,ff,attn,attn_pv,proj")
    reset_launches()
    card_pipe(prompts, x_T=torch.from_numpy(x_T).cuda(), **run)
    counts = read_launches()
    got = card_pipe.last_latents.cpu()
    rel = lambda a: ((a - want).norm() / want.norm()).item()
    log(f"[int8 reference] tiny model at {hw}², every bucket in bf16 on the card vs fp32 on the "
        f"CPU without int8, PLMS 5: relative L2 {rel(got):.4e} (bound {AGREEMENT_TOL}); the "
        f"card's bf16 run {rel(bf16):.4e}; launches {counts}")
    for k in ("flash_attention_int8", "int8_dense", "int8_conv3x3"):
        if counts[k] == 0:
            raise AssertionError(f"the tiny int8 run did not reach {k}")
    if not (np.isfinite(rel(got)) and rel(got) < AGREEMENT_TOL) or torch.equal(got, bf16):
        raise AssertionError(f"tiny int8 run: relative L2 {rel(got)} (or identical to bf16)")


def reset_launches() -> None:
    for fn in _counted().values():
        fn.launches = 0
    _counted()["flash_attention_int8"].pv_launches = 0


def read_launches() -> dict:
    counts = {k: fn.launches for k, fn in _counted().items()}
    counts["flash_attention_int8_qkpv"] = _counted()["flash_attention_int8"].pv_launches
    return counts


def expect(**nonzero) -> dict:
    """An expected count for every counter: those given, 0 elsewhere."""
    want = dict.fromkeys(read_launches(), 0)
    want.update(nonzero)
    return want


def build_sd_v1(int8: str):
    from sd_tpu_torch.ops.quant import int8_mode_label
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline

    t0 = time.perf_counter()
    pipe, _ = build_txt2img_pipeline(device="cuda", seed=0, watermark=False, int8=int8)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.ldm.parameters())
    label = int8_mode_label(pipe.ldm.int8_mode, "cuda")
    log(f"[serve {label}] SD v1 full width, {n_params / 1e6:.1f}M parameters in bf16, built "
        f"(weights quantized) in {time.perf_counter() - t0:.1f} s")
    return pipe, label


def serve(pipe, label: str, requests: int, batch: int, want: dict) -> dict:
    """``requests`` requests of ``batch`` prompts at 512², PLMS 50, guidance
    7.5, request r drawing from a generator seeded r; the launch counters,
    reset just before, must equal ``want`` times ``requests``. Returns the
    counts, each request's final latents and seconds."""
    log(f"[serve {label}] {requests} request(s) of batch {batch}, 512x512, PLMS {STEPS} steps, "
        f"guidance 7.5 (no cut)")
    latents, seconds = [], []
    reset_launches()
    for r in range(requests):
        gen = torch.Generator(device="cuda").manual_seed(r)
        images = pipe([PROMPT] * batch, gen, height=512, width=512, steps=STEPS,
                      guidance_scale=7.5)
        t = pipe.last_timings
        z = pipe.last_latents
        log(f"[serve {label}] request {r}: {t['total_s']:.3f} s (encode {t['encode_s']:.3f}, "
            f"sample {t['sample_s']:.3f}, decode {t['decode_s']:.3f}); "
            f"{t['sample_s'] * 1e3 / (STEPS + 1):.2f} ms per UNet evaluation (B={2 * batch}); "
            f"{batch / t['total_s']:.3f} images/s")
        if images.shape != (batch, 512, 512, 3) or images.dtype != np.uint8:
            raise AssertionError(f"request {r}: images {images.shape} {images.dtype}")
        if any(img.min() == img.max() for img in images):
            raise AssertionError(f"request {r}: constant image")
        if not torch.isfinite(z).all():
            raise AssertionError(f"request {r}: latents not finite")
        latents.append(z.float().cpu())
        seconds.append(t["total_s"])
    counts = read_launches()
    want = {k: requests * v for k, v in want.items()}
    log(f"[serve {label}] launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"launch counts {counts} != {want}")
    return {"launches": counts, "latents": latents, "seconds": seconds}


def serve_main_path() -> dict:
    pipe, label = build_sd_v1("off")
    out = serve(pipe, label, REQUESTS, 1, expect(
        flash_attention=SITES_PER_UNET * (STEPS + 1) + 1,
        geglu_ff=SITES_PER_UNET * (STEPS + 1)))
    batch8 = serve(pipe, label, 1, BATCH8, expect(
        flash_attention=SITES_PER_UNET * (STEPS + 1) + 1,
        geglu_ff=SITES_PER_UNET * (STEPS + 1)))
    out["batch8_seconds"] = batch8["seconds"][0]
    return out


def conv3x3_calls(ldm) -> int:
    """int8 conv calls per request: each Conv3x3 of the UNet once per UNet
    evaluation, each of the decoder once."""
    from sd_tpu_torch.ops.conv import Conv3x3

    n = lambda m: sum(isinstance(x, Conv3x3) for x in m.modules())
    return n(ldm.model.diffusion_model) * (STEPS + 1) + n(ldm.first_stage_model.decoder)


def serve_int8(bf16: dict) -> dict:
    """The int8 serving mode at SD v1 full width: "all" at batch 1 with the
    agreement gate, every bucket, and "all" at batch 8."""
    s1 = STEPS + 1
    pipe, label = build_sd_v1("all")
    convs = conv3x3_calls(pipe.ldm)
    int8 = serve(pipe, label, REQUESTS, 1, expect(
        flash_attention_int8=5 * s1 + 1, flash_attention=11 * s1, geglu_ff_int8=5 * s1,
        geglu_ff=11 * s1, int8_conv3x3=convs))
    z8, z16 = int8["latents"][0], bf16["latents"][0]
    rel = ((z8 - z16).norm() / z16.norm()).item()
    log(f"[serve {label}] agreement: request 0's latents against the bf16 request 0, relative "
        f"L2 {rel:.5f} (bound {AGREEMENT_TOL}); identical: {torch.equal(z8, z16)}")
    if not (np.isfinite(rel) and rel < AGREEMENT_TOL) or torch.equal(z8, z16):
        raise AssertionError(f"int8 serving disagrees with bf16: relative L2 {rel}")

    batch8 = serve(pipe, label, 1, BATCH8, expect(
        flash_attention_int8=5 * s1 + 1, flash_attention=11 * s1, geglu_ff_int8=11 * s1,
        geglu_ff=5 * s1, int8_conv3x3=convs))
    log(f"[serve] batch {BATCH8}: int8 {BATCH8 / batch8['seconds'][0]:.3f} images/s, bf16 "
        f"{BATCH8 / bf16['batch8_seconds']:.3f} images/s")

    pipe.ldm.set_int8_mode("conv,ff,attn,attn_pv,proj")
    every = serve(pipe, "bf16+int8[every bucket]", 1, 1, expect(
        flash_attention_int8=5 * s1 + 1, flash_attention_int8_qkpv=1, flash_attention=11 * s1,
        geglu_ff_int8=5 * s1, geglu_ff=11 * s1, int8_dense=4 * SITES_PER_UNET * s1,
        int8_conv3x3=convs))
    total = {k: int8["launches"][k] + batch8["launches"][k] + every["launches"][k]
             for k in int8["launches"]}
    return total


def _tiny_loss_and_grads(trainer, batch, t, noise):
    """One loss of ``p_losses`` and the UNet gradients, with the batch's
    latents at the posterior's mode and the given t and noise."""
    from sd_tpu_torch.training.diffusion_loss import p_losses

    ldm, device = trainer.ldm, trainer.device
    x = torch.from_numpy(batch["image"]).to(device).permute(0, 3, 1, 2)
    tokens = torch.from_numpy(batch["caption"]).to(device).long()
    trainer.unet.zero_grad(set_to_none=True)
    with torch.no_grad(), trainer.autocast():
        z = ldm.encode_to_latent(x).float()
        cond = ldm.get_learned_conditioning(tokens)
    with trainer.autocast():
        loss, _ = p_losses(ldm.apply_model, ldm.schedule, z, cond, t.to(device),
                           noise.to(device))
    loss.backward()
    return loss.item(), {n: p.grad.float().cpu() for n, p in trainer.unet.named_parameters()}


def check_training_reference() -> None:
    from sd_tpu_torch.data.synthetic import SyntheticImages
    from sd_tpu_torch.data.base import collate
    from sd_tpu_torch.training.diffusion_loss import create_train_state
    from sd_tpu_torch.utils.config import build_latent_diffusion, train_config

    model_cfg = train_config(tiny=True)["model"]
    cpu_ldm = build_latent_diffusion(model_cfg, device="cpu", seed=0)
    card_ldm = copy.deepcopy(cpu_ldm).cuda()
    cpu_trainer, _ = create_train_state(cpu_ldm, 1e-3, use_ema=False)
    card_trainer, card_state = create_train_state(card_ldm, 1e-3, use_ema=False)
    batch = collate([SyntheticImages(size=128, length=2)[i] for i in range(2)])
    rng = np.random.default_rng(0)
    t = torch.from_numpy(np.array([17, 633]))
    noise = torch.from_numpy(rng.standard_normal((2, 4, 64, 64)).astype(np.float32))

    want_loss, want = _tiny_loss_and_grads(cpu_trainer, batch, t, noise)
    reset_launches()
    got_loss, got = _tiny_loss_and_grads(card_trainer, batch, t, noise)
    launches = read_launches()
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    diff = sum((got[n] - want[n]).square().sum() for n in want).sqrt().item()
    norm = sum(want[n].square().sum() for n in want).sqrt().item()
    # each tensor's error over its allowance (<= 1 passes)
    score = {n: ((got[n] - want[n]).norm()
                 / (TRAIN_TENSOR_TOL * want[n].norm() + TRAIN_TENSOR_FLOOR * norm)).item()
             for n in want}
    worst = max(score, key=score.get)
    negligible = sum(want[n].norm().item() < 1e-6 * norm for n in want)
    log(f"[train reference] tiny model at 128², bf16 autocast card vs fp32 CPU: loss "
        f"{got_loss:.6f} vs {want_loss:.6f} (relative {loss_rel:.3e}, bound {TRAIN_LOSS_TOL}); "
        f"UNet gradients relative L2 {diff / norm:.3e} (bound {TRAIN_GRAD_TOL}); worst tensor "
        f"{worst} at {score[worst]:.3e} of its bound; {negligible} of {len(want)} tensors with a "
        f"reference gradient below 1e-6 of the whole; launches {launches}")
    if launches["flash_attention_bwd"] == 0:
        raise AssertionError("the tiny training step did not reach K3")
    if not (loss_rel <= TRAIN_LOSS_TOL and diff / norm <= TRAIN_GRAD_TOL and score[worst] <= 1):
        raise AssertionError("tiny training step disagrees with its fp32 CPU reference")

    # 20 constant-LR steps on one fixed batch, with the same draws every step
    losses = []
    for _ in range(20):
        gen = torch.Generator("cuda").manual_seed(0)
        losses.append(float(card_trainer.train_step(card_state, batch, gen)["loss"]))
    log(f"[train reference] 20 steps on one batch, AdamW at 1e-3: loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
    if not (np.all(np.isfinite(losses)) and np.mean(losses[-5:]) < 0.8 * losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")


def train_main_path() -> dict:
    # Trainer.fit saves last.pt on exit (about 10 GB at this width): the
    # directory goes whether the phase passes or fails
    with tempfile.TemporaryDirectory(prefix="sd_v1_train_") as logdir:
        return _train(logdir)


def _train(logdir: str) -> dict:
    from sd_tpu_torch.scripts.train import build_trainer, parse_args
    from sd_tpu_torch.utils.checkpoint import latest_checkpoint

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    harness, state, data = build_trainer(parse_args(
        ["--max_steps", str(TRAIN_STEPS), "--logdir", logdir, "--seed", "0", "--log_every", "1",
         "--ckpt_every", str(10 * TRAIN_STEPS)]))
    torch.cuda.synchronize()
    unet = state.unet
    n_params = sum(p.numel() for p in unet.parameters())
    batch = data.batch_size
    log(f"[train] SD v1 full width, {n_params / 1e6:.1f}M UNet parameters in fp32 (AdamW, "
        f"bf16 autocast, use_checkpoint {unet.config.use_checkpoint}), frozen kl-f8 encoder and "
        f"CLIP in bf16; batch {batch} of 512² images, 77-token captions; built in "
        f"{time.perf_counter() - t0:.1f} s; {TRAIN_STEPS} steps (no cut)")
    named = dict(unet.named_parameters())
    for site in ("attn1.to_q", "attn1.to_k", "attn1.to_v", "ff.net.0.proj"):
        if not any(site in n for n in named):
            raise AssertionError(f"no UNet parameter named *{site}*")
    times = []
    last = {"t": time.perf_counter(), "launches": read_launches()}
    train_step = harness.trainer_obj.train_step

    def checked_step(state_, batch_, generator):
        """The trainer's step, then this phase's checks of it."""
        aux = train_step(state_, batch_, generator)
        torch.cuda.synchronize()
        now = time.perf_counter()
        step = state_.step
        launches = read_launches()
        delta = {k: launches[k] - last["launches"][k] for k in launches}
        times.append(now - last["t"])
        loss = float(aux["loss"])
        bad = [n for n, p in named.items()
               if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.any()]
        log(f"[train] step {step}: loss {loss:.5f}, {times[-1] * 1e3:.1f} ms, launches {delta}, "
            f"parameters without a finite non-zero gradient: {len(bad)} of {len(named)}")
        if not np.isfinite(loss):
            raise AssertionError(f"step {step}: loss {loss}")
        if bad:
            raise AssertionError(f"step {step}: no finite non-zero gradient on {bad[:8]}")
        if delta != expect(**TRAIN_LAUNCHES):
            raise AssertionError(f"step {step}: launches {delta} != {TRAIN_LAUNCHES}")
        last["t"] = time.perf_counter()
        last["launches"] = launches
        return aux

    harness.trainer_obj.train_step = checked_step
    reset_launches()
    last["launches"] = read_launches()
    last["t"] = time.perf_counter()
    harness.fit(state, data)
    # after the last step fit only saves last.pt
    save_s = time.perf_counter() - last["t"]
    launches = read_launches()
    ckpt = latest_checkpoint(harness.ckpt_dir)
    if ckpt is None:
        raise AssertionError("Trainer.fit saved no checkpoint on exit")
    log(f"[train] save on exit: {save_s:.2f} s, {os.path.getsize(ckpt) / 2**30:.2f} GiB")
    moments = state.optimizer.state
    flat = [n for n, p in named.items()
            if not (moments[p]["exp_avg"].any() and moments[p]["exp_avg_sq"].any())]
    if flat:
        raise AssertionError(f"AdamW moments zero on {flat[:8]}")
    steady = times[1:]
    ms = 1e3 * float(np.median(steady))
    log(f"[train] {TRAIN_STEPS} steps: {' '.join(f'{t * 1e3:.1f}' for t in times)} ms; median of "
        f"steps 2-{TRAIN_STEPS} {ms:.1f} ms per step, {batch / ms * 1e3:.3f} images/s; peak "
        f"memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; AdamW moments "
        f"non-zero on all {len(named)} parameters; launches {launches}")
    return launches


def free_memory() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = check_device()
    build()
    timings = check_kernels()
    timings.update(check_int8_kernels())
    check_reference()
    check_int8_reference()
    served = serve_main_path()
    free_memory()
    served_int8 = serve_int8(served)
    free_memory()
    check_training_reference()
    free_memory()
    trained = train_main_path()
    source = {"flash_attention": ("sd_tpu_torch/csrc/flash_attention.cu",
                                  "sd_tpu/ops/pallas/flash_attention.py:324"),
              "geglu_ff": ("sd_tpu_torch/csrc/geglu_ff.cu",
                           "sd_tpu/ops/pallas/geglu_ff.py:255"),
              "flash_attention_bwd": ("sd_tpu_torch/csrc/flash_attention_bwd.cu",
                                      "sd_tpu/ops/pallas/flash_attention.py:490"),
              "geglu_ff_int8": ("sd_tpu_torch/csrc/geglu_ff_int8.cu",
                                "sd_tpu/ops/pallas/geglu_ff.py:313"),
              "flash_attention_int8": ("sd_tpu_torch/csrc/flash_attention_int8.cu",
                                       "sd_tpu/ops/pallas/flash_attention.py:225"),
              "int8_dense": ("sd_tpu_torch/csrc/int8_dense.cu",
                             "sd_tpu/ops/pallas/int8_dense.py:66")}
    kernels = []
    for k, rows in timings.items():
        library = [r["library_ms"] for r in rows]
        ops_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        kernels.append({
            "name": k, "route": "cuda", "source": source[k][0], "replaces": source[k][1],
            "launches": served["launches"][k] + served_int8[k] + trained[k],
            "max_abs_err": max(r["err"] for r in rows),
            "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if 2 * ops_ms >= sum(r["bound_ms"] for r in rows)
            else "bytes",
            "library_ms": None if None in library else sum(library)})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
