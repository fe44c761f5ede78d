#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA card: txt2img
serving in bf16, in the int8 serving mode and in the two conv modes, LDM
training, and the fused transformer-block experiment, all at SD v1 full
width.

    python3 chip_smoke.py

Phases, one or more lines each; any failure raises and the exit code is not 0:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds sd_tpu_torch/csrc into build/sd_tpu_torch (git-ignored);
3. K1 flash attention and 4. K2 GEGLU feed-forward: each kernel against its
   plain PyTorch version at every shape of the serving path at batch 1 with
   guidance (B=2), of the training path at batch 4 and of the serving path
   at batch 8 (B=16), and (K2) at one ragged shape, bf16 inputs, the plain
   version computed in fp32
   from the same inputs (one batch element at a time where its logits would
   pass 2 GiB); K1's row log-sum-exp (the statistic K3 reads) against its
   plain version too, and every K1 shape a second time with sharp logits
   (q times SHARP); K1's launch plan at each shape (blocks, shared memory,
   blocks per SM, waves) and K2's per GEMM (a block's rows and columns,
   stages, blocks, k splits, waves) at each shape; max abs error and the ms
   of each (CUDA events), the bound, and the ms of one PyTorch call
   computing the same function (scaled_dot_product_attention for K1; none
   for K2, whose yardstick is the unfused bf16 FF: F.linear, chunk, F.gelu,
   multiply, F.linear);
5. K3 flash-attention backward: at the training path's two shapes, with
   plain and with sharp logits, dQ, dK and dV from K1 + K3 against the plain
   backward in fp32 on the same bf16 inputs; the yardstick is
   scaled_dot_product_attention's forward+backward minus its forward;
6. reference: the tiny model in bf16 on the card against the same weights in
   fp32 on the CPU (plain versions), 5 PLMS steps, latents compared; then
   the fp32 opt-out: SD_TPU_PRECISION=fp32 builds the tiny model in fp32 on
   the card (TF32 off for matmul and cuDNN), which samples against its fp32
   CPU run, and one tiny training loss and its gradients in fp32 outside
   autocast against the CPU, with no K1, K2 or K3 launch;
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
   otherwise (K2, K1, F.linear; for K6 also torch._int_mm on the same
   codes, the library's int8 product alone), and K5's and K6's launch plans
   at each shape; each
   kernel within its own bound (INT8_TOL), which the bf16 path's output
   (and, for K5 "qkpv", K5 "qk"'s) must exceed at every shape, so that a
   kernel skipping its quantization fails; K5 "qkpv" at d=40 too (its
   narrow kernel, on no serving path: within INT8_TOL, not timed);
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
   request;
13. K7 fused GroupNorm-apply + SiLU + conv3x3: against its plain version
   (fp32 on the same bf16 inputs) at every launch shape and flag set of the
   fused serving path (a block's first launch: prologue + moments; its
   second: prologue + bias + skip), given its weight repacked as the
   resnet blocks give it, with its launch plan and the ms of the unfused
   site (GroupNorm32, SiLU, F.conv2d with bias, + skip, and the next
   GroupNorm's statistics) and of cuDNN's conv alone on h; one gradient
   through K7's autograd function against the plain backward;
14. K8 and X3 Winograd F(2x2,3x3): given U (as Conv3x3 keeps it), against
   their plain versions and F.conv2d (cuDNN, the library yardstick) at
   every K8 site shape of the serving path, at the X3 experiment of
   tools/exp_winograd.py (timing_split) at its four levels at B=16, K8
   beside it, and at two ragged shapes (WINO_RAGGED); the launch plan the
   library chooses at each, the kernel's ms with U given and the whole
   call's; X3's launches are counted over that experiment;
15. conv-mode reference: the small UNet of tests/test_torch_conv_modes.py
   (model_channels 128, channel_mult [1, 2], 32² latents) in bf16 on the
   card with both modes against fp32 on the CPU;
16. conv-mode serving: SD v1 serves one request in each conv mode with the
   bf16 phase's generator 0: SD_TPU_FUSED_CONV=1, SD_TPU_CONV_IMPL=winograd,
   and both; exact K7 and K8 launches per request (from the gates: 8 UNet and
   10 decoder blocks fused; 21 UNet and 31 decoder Winograd sites alone,
   16 and 11 beside the fused blocks), K1 and K2 as in bf16, and each
   request's latents within relative L2 0.10 of the bf16 request 0's and
   not identical to them; then one more bf16 request, so that bf16 and the
   modes take turns on the card;
17. X1 and X2, the fused transformer-block kernels of the block experiment
   (tools/exp_block_kernel.py): each against its plain version (fp32 on the
   same bf16 inputs, the experiment's; X2's padded context rows non-zero,
   so that its mask shows) at SD v1's four transformer sites at B=16, the
   bound set by the branch, what the kernel adds to x, not by the output,
   with the ms of the unfused yardstick (the port's LayerNormFp32,
   CrossAttention with K1, FeedForward with K2), and X1∘X2 on a port
   BasicTransformerBlock against the block itself in bf16 (relative L2
   within BLOCK_AGREEMENT_TOL);
18. the block experiment: `python -m sd_tpu_torch.scripts.exp_block_kernel`
   and `... tail` at their defaults (N=4096, C=320), through their main();
   the launches, reset just before each, must be exactly 2 + 2 x 30 X1 and
   K1 launches, then 2 + 2 x 30 X2 and K2 launches.

The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Without CUDA it fails before printing either.
"""

import contextlib
import copy
import gc
import importlib
import json
import os
import re
import subprocess
import tempfile
import time
from typing import Optional

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
# the decoder's mid-block at B=1), then training at batch 4 (the encoder's),
# then serving at batch 8 (B=16; the decoder's at B=8)
FLASH_SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 256, 8, 160), (2, 64, 8, 160),
                (1, 4096, 1, 512),
                (4, 4096, 8, 40), (4, 1024, 8, 80), (4, 256, 8, 160), (4, 64, 8, 160),
                (4, 4096, 1, 512),
                (16, 4096, 8, 40), (16, 1024, 8, 80), (16, 256, 8, 160), (16, 64, 8, 160),
                (8, 4096, 1, 512)]
# (M, C, inner): the transformer FF blocks, M = B * tokens: serving at batch 1
# (B=2), training at batch 4, serving at batch 8 (B=16; its 8x8 site,
# M=1024, is training's 16x16 one), and one ragged shape (M not a multiple
# of any block's rows)
FF_SHAPES = [(8192, 320, 1280), (2048, 640, 2560), (512, 1280, 5120), (128, 1280, 5120),
             (16384, 320, 1280), (4096, 640, 2560), (1024, 1280, 5120), (256, 1280, 5120),
             (65536, 320, 1280), (16384, 640, 2560), (4096, 1280, 5120), (1000, 320, 1280)]
# (B, N, H, D): the training sites that take K3 (N > 256) at batch 4
BWD_SHAPES = [(4, 4096, 8, 40), (4, 1024, 8, 80)]
# bf16 rounds to 8 mantissa bits (2^-9 relative) at P or h, at dS and at the
# outputs; the error bound is 2e-2 of the output's scale: max |plain| for K1
# and K3, whose outputs are well below 1, and max(1, max |plain|) for K2
KERNEL_TOL = 2e-2
# K1's log-sum-exp is fp32 throughout: absolute bound in log2 units
LSE_TOL = 1e-3
# every K1 and K3 shape runs a second time with q scaled by this, so that
# the logits (std about 4) pick out a few keys: near-uniform logits hardly
# move the running max and can hide a wrong rescale of O
SHARP = 4.0
# the fp32 model on the card (SD_TPU_PRECISION=fp32, TF32 off for matmul and
# cuDNN) against fp32 on the CPU, the same ops summed in other orders, for
# each of: max |diff| / max |ref| of the tiny model's latents after 6 UNet
# calls with guidance 7.5 (the CPU's fp32 run reads 2.5e-6 against its fp64
# run; the card's bf16 run about 1e-2), a training loss (relative) and its
# UNet gradients (relative L2)
FP32_TOL = 1e-3
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
# K5 "qkpv" at d <= 48 (its narrow kernel), which no serving path takes
# (attn_pv gives "qkpv" at d >= 256 only): checked within INT8_TOL, not timed
INT8_FLASH_OFF_PATH = [(2, 4096, 8, 40, "qkpv")]
# (M, C, F): the proj bucket's self-attention QKV (F = 3C), cross q and
# to_out (F = C), batch 1 then batch 8
INT8_DENSE_SHAPES = [(b * n, c, f * c) for b in (2, 16)
                     for n, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280))
                     for f in (3, 1)]
# the flagship agreement gate of tools/int8_quality.py: int8 (or a conv
# mode) against bf16 latents after the whole trajectory, relative L2
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

# K7's launches of the fused serving path: (B, C, H=W, N, launch), "first"
# (prologue + moments) or "second" (prologue + bias + skip), the UNet's
# blocks at B=2, the decoder's at B=1
FUSED_SHAPES = ([(2, c, hw, n, "first") for c, hw, n in (
    (640, 32, 640), (640, 16, 1280), (1280, 16, 1280), (2560, 16, 1280), (1920, 16, 1280),
    (1920, 32, 640), (1280, 32, 640))]
    + [(2, 640, 32, 640, "second"), (2, 1280, 16, 1280, "second")]
    + [(1, c, hw, c, launch) for c, hw in ((512, 64), (512, 128), (256, 256))
       for launch in ("first", "second")])
# K8's sites (B, C, H=W, K): the UNet's at 64² and 32² at B=2, the decoder's
WINO_SHAPES = [(2, 320, 64, 320), (2, 960, 64, 320), (2, 640, 64, 320), (2, 640, 64, 640),
               (2, 320, 32, 640), (2, 640, 32, 640), (2, 1280, 32, 640), (2, 960, 32, 640),
               (2, 1280, 32, 1280), (1, 512, 64, 512), (1, 512, 128, 512), (1, 512, 256, 512),
               (1, 512, 256, 256), (1, 256, 256, 256), (1, 256, 512, 256), (1, 256, 512, 128),
               (1, 128, 512, 128)]
# tools/exp_winograd.py's LEVELS at its B=16: X3's experiment path
X3_LEVELS = [(16, 320, 64, 320), (16, 640, 32, 640), (16, 1280, 16, 1280), (16, 1280, 8, 1280)]
# K8 and X3 off the plans' multiples (B, C, H, W, K): tile grids of 9 x 17
# and 11 x 20, C not a multiple of the channel step, K not of a block's
# channels; W = 34 takes X3's 4-byte copies, W = 40 its 16-byte ones
WINO_RAGGED = [(1, 136, 18, 34, 136), (2, 200, 22, 40, 264)]
# K7's and K8's sites per request of SD v1 (gates of sd_tpu, asserted equal
# on these shapes by tests/test_torch_conv_modes.py): fused blocks (two
# launches each) and Winograd Conv3x3 calls per UNet evaluation and in the
# decoder, alone and beside the fused blocks
FUSED_BLOCKS = {"unet": 8, "decoder": 10}
WINO_SITES = {"unet": 21, "decoder": 31}
WINO_SITES_BESIDE_FUSED = {"unet": 16, "decoder": 11}
# the small UNet with both conv modes, bf16 on the card against fp32 on the
# CPU: max |diff| of the output over max |fp32 output|
CONV_MODES_TOL = 5e-2
# the block experiment (tools/exp_block_kernel.py) at SD v1's four
# transformer sites (N, C), at its B=16 with 8 heads, inner 4C, and 77
# context keys of 128 rows
BLOCK_SITES = [(4096, 320), (1024, 640), (256, 1280), (64, 1280)]
# X1∘X2 on a port BasicTransformerBlock against the block itself, both bf16
# on the card: relative L2 of the outputs. They round at other points (the
# single-pass LayerNorm variance, P against a per-tile or per-row max,
# bias rounding), each about 2^-9 relative
BLOCK_AGREEMENT_TOL = 1e-2
CONTEXT_DIM = 768  # SD v1's CLIP ViT-L/14 text width
# K7's gradient through the autograd function (bf16 inputs, so bf16
# per-pixel gradients) against the plain backward in fp32: relative L2 of
# each gradient. The per-channel gradients (da, dd, dbias) sum per-pixel
# terms of both signs, whose 2^-9 roundings survive the cancellation: 1.3e-2
# and 1.5e-2 at a small shape on the CPU
FUSED_GRAD_TOL = 5e-2


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
    kernel, seen = None, set()
    for line in lines:
        if "Function properties for" in line:
            kernel = line.rsplit(" ", 1)[-1]
        elif "spill" in line and not line.startswith("0 bytes") and kernel not in seen:
            log(f"[build]   {kernel}: {line}")
        elif "Used" in line and kernel not in seen:
            # K1's, K3's, K5's, K8's, X3's, K2's, K7's and K6's kernels by
            # name and template arguments
            name = re.search(r"flash_(?:fwd|bwd)_[a-z_]*kernel(?:_wide)?|winograd_kernel|"
                             r"int8_attn_kernel(?:_wide)?|geglu_gemm_kernel|"
                             r"fused_conv(?:_reduce)?_kernel|int8_dense_kernel", kernel or "")
            if name:
                args = ",".join(re.findall(r"L[ib](\d+)E", kernel))
                log(f"[build]   {name.group(0)}<{args}>: {line.split(':', 1)[1].strip()}")
            seen.add(kernel)


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


class CheckFailed(AssertionError):
    """A kernel's output outside its bound: ``err`` against ``limit``."""

    def __init__(self, msg: str, err: float, limit: float):
        super().__init__(msg)
        self.err, self.limit = err, limit


def check_error(name: str, shape, got: torch.Tensor, ref: torch.Tensor,
                scale_floor: float = 0.0, tol: float = KERNEL_TOL,
                residual: Optional[torch.Tensor] = None) -> float:
    """max |got − ref| within ``tol`` of the scale: max(scale_floor,
    max |ref|), or with ``residual`` max |ref − residual|, the branch a
    kernel adds to its residual input, so that a fault in a branch much
    smaller than the residual still shows."""
    err = (got.float() - ref).abs().max().item()
    label = "max |plain|" if residual is None else "max |plain - x|"
    ref_max = (ref if residual is None else ref - residual.float()).abs().max().item()
    limit = tol * max(scale_floor, ref_max)
    ok = np.isfinite(err) and err <= limit
    log(f"[{name}] {shape}: max_abs_err {err:.3e} ({label} {ref_max:.3e}, bound "
        f"{limit:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise CheckFailed(f"{name} at {shape}: max abs error {err} above {limit}", err, limit)
    return err


def check_lse(shape, got: torch.Tensor, ref: torch.Tensor) -> float:
    """K1's row log-sum-exp within LSE_TOL (absolute, log2 units)."""
    err = (got - ref).abs().max().item()
    log(f"[K1 flash_attention] {shape}: log-sum-exp max_abs_err {err:.3e} (bound {LSE_TOL})")
    if not (np.isfinite(err) and err <= LSE_TOL):
        raise CheckFailed(f"K1 log-sum-exp at {shape}: {err}", err, LSE_TOL)
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


def by_batch(fn, *tensors):
    """``fn`` over one batch element at a time, concatenated: the same
    function, for the plain references whose [B, H, N, N] fp32 logits would
    not fit beside the timings."""
    return torch.cat([fn(*(t[i:i + 1] for t in tensors)) for i in range(tensors[0].shape[0])])


def log_plan(which: str, shape) -> None:
    """The launch plan of K1, of a K3 pass or of K5 at ``shape``: its blocks and
    the waves they take on this card."""
    from sd_tpu_torch.ops.cuda.flash_attention import kernel_plan

    b, n, h, d = shape
    plan = kernel_plan(d, which, (b, n, h))
    blocks = -(-n // plan["rows"]) * h * b
    slots = plan["blocks_per_sm"] * torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[{which} plan] {shape}: {plan['rows']} rows a block, tiles of {plan['tile']}, "
        f"{plan['threads']} threads, {plan['smem_bytes']} bytes of shared memory, "
        f"{plan['blocks_per_sm']} blocks per SM; {blocks} blocks, {blocks / slots:.2f} waves")


def flash_case(randn, shape, sharp: bool = False, timed: bool = True) -> dict:
    """K1 at one shape against its plain version (output and row
    log-sum-exp); with ``sharp``, q scaled by SHARP. Timed: the kernel, the
    plain version, sdpa and the bound."""
    from sd_tpu_torch.ops.cuda import (flash_attention, flash_attention_lse_plain,
                                       flash_attention_plain)
    from sd_tpu_torch.ops.cuda.flash_attention import _launch_forward

    b, n, h, d = shape
    scale = d**-0.5
    bf = [randn(*shape).to(torch.bfloat16) for _ in range(3)]
    if sharp:
        bf[0] = bf[0] * SHARP
    label = f"{shape}{' sharp' if sharp else ''}"
    out = flash_attention(*bf, scale)
    # the log-sum-exp that only the autograd path asks K1 for
    lse = _launch_forward(*bf, scale, with_lse=True)[1]
    torch.cuda.synchronize()
    fp = [t.float() for t in bf]
    big = b * h * n * n * 4 > 2**31
    plain = lambda *t: flash_attention_plain(*t, scale)
    lse_plain = lambda q, k: flash_attention_lse_plain(q, k, scale)
    ref, lse_ref = ((by_batch(plain, *fp), by_batch(lse_plain, *fp[:2])) if big
                    else (plain(*fp), lse_plain(*fp[:2])))
    err = check_error("K1 flash_attention", label, out, ref)
    check_lse(label, lse, lse_ref)
    del fp
    if not timed:
        return dict(err=err)
    ms = time_ms(lambda: flash_attention(*bf, scale))
    plain_ms = time_ms(lambda: flash_attention_plain(*bf, scale), iters=5 if big else 20)
    library_ms = time_ms(lambda: sdpa(*bf, scale))
    bnd = bound(4 * b * h * n * n * d, 4 * b * n * h * d * 2)
    log(f"[K1 flash_attention] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sdpa {library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bnd)


def check_flash(randn) -> list:
    rows = []
    for shape in FLASH_SHAPES:
        log_plan("K1", shape)
        row = flash_case(randn, shape)
        row["err"] = max(row["err"], flash_case(randn, shape, sharp=True, timed=False)["err"])
        rows.append(row)
        free_memory()
    return rows


def log_ff_plan(shape) -> None:
    """K2's plan at ``shape`` per GEMM: a tile's rows and columns, the
    stages, the tiles (k splits counted), the persistent blocks and their
    clusters, and the tiles the busiest block runs."""
    from sd_tpu_torch.ops.cuda.geglu_ff import kernel_plan

    parts = []
    for name, p in kernel_plan(*shape).items():
        parts.append(f"{name} {p['rows']}x{p['cols']} tiles, {p['stages']} stages, "
                     f"{p['tiles']} tiles ({p['splits']} k splits) over {p['blocks']} blocks "
                     f"in clusters of {p['cluster']}, {-(-p['tiles'] // p['blocks'])} a block "
                     f"at most")
    log(f"[K2 plan] {shape}: " + "; ".join(parts))


def unfused_ff(x, w1, b1, w2, b2):
    """The FF as five bf16 library calls (cuBLAS): the yardstick of K2."""
    a, g = F.linear(x, w1, b1.to(x.dtype)).chunk(2, dim=-1)
    return F.linear(a * F.gelu(g), w2, b2.to(x.dtype))


def geglu_case(randn, shape, timed: bool = True) -> dict:
    """K2 at one (M, C, inner) against its plain version (fp32 on the same
    bf16 inputs). Timed: the kernel, the plain version, the unfused bf16 FF
    and the bound (h's round trip beside it)."""
    from sd_tpu_torch.ops.cuda import geglu_ff, geglu_ff_plain

    m, c, inner = shape
    args = [randn(m, c), randn(2 * inner, c) * c**-0.5, 0.1 * randn(2 * inner),
            randn(c, inner) * inner**-0.5, 0.1 * randn(c)]
    bf = [a.to(torch.bfloat16) if a.ndim == 2 else a for a in args]
    out = geglu_ff(*bf)
    torch.cuda.synchronize()
    err = check_error("K2 geglu_ff", shape, out, geglu_ff_plain(*[a.float() for a in bf]),
                      scale_floor=1.0)
    if not timed:
        return dict(err=err)
    ms = time_ms(lambda: geglu_ff(*bf))
    plain_ms = time_ms(lambda: geglu_ff_plain(*bf))
    unfused_ms = time_ms(lambda: unfused_ff(*bf))
    nbytes = (2 * m * c + 3 * inner * c) * 2 + (2 * inner + c) * 4 + m * c * 2
    bnd = bound(6 * m * c * inner, nbytes)
    h_ms = 2 * m * inner * 2 / PEAK_BYTES * 1e3
    log(f"[K2 geglu_ff] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused "
        f"{unfused_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}); h's round "
        f"trip {h_ms:.4f} ms of bytes")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, unfused_ms=unfused_ms,
                **bnd)


def check_geglu(randn) -> list:
    rows = []
    for shape in FF_SHAPES:
        log_ff_plan(shape)
        rows.append(geglu_case(randn, shape))
        free_memory()
    return rows


def flash_bwd_case(randn, shape, sharp: bool = False, timed: bool = True) -> dict:
    """K1 + K3 at one shape: the forward output of the autograd path, then
    dQ, dK and dV against the plain backward in fp32 on the same bf16
    inputs; with ``sharp``, q scaled by SHARP. Timed: K3, the plain
    backward, sdpa's backward (forward+backward minus forward), the bound."""
    from sd_tpu_torch.ops.cuda import (differentiable_flash_attention, flash_attention_bwd,
                                       flash_attention_bwd_plain, flash_attention_plain)
    from sd_tpu_torch.ops.cuda.flash_attention import _launch_forward

    b, n, h, d = shape
    scale = d**-0.5
    label = f"{shape}{' sharp' if sharp else ''}"
    q, k, v = (randn(*shape).to(torch.bfloat16) for _ in range(3))
    if sharp:
        q = q * SHARP
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    do = randn(*shape).to(torch.bfloat16)
    o = differentiable_flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    check_error("K1 differentiable_flash_attention", label, o,
                flash_attention_plain(*(t.detach().float() for t in (q, k, v)), scale))
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    q, k, v, o = (t.detach() for t in (q, k, v, o))
    refs = flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o, do)), scale)
    err = max(check_error(f"K3 flash_attention_bwd d{name}", label, g, r)
              for name, g, r in zip("QKV", grads, refs))
    if not timed:
        return dict(err=err)
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
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bnd)


def check_flash_bwd(randn) -> list:
    rows = []
    for shape in BWD_SHAPES:
        log_plan("K3 dK/dV", shape)
        log_plan("K3 dQ", shape)
        row = flash_bwd_case(randn, shape)
        row["err"] = max(row["err"], flash_bwd_case(randn, shape, sharp=True, timed=False)["err"])
        rows.append(row)
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


def int8_flash_case(randn, shape, timed: bool = True, gate: bool = True) -> dict:
    """K5 at one (B, N, H, D, mode) against its plain version (fp32 on the
    same bf16 inputs) within INT8_TOL; with ``gate``, K1's output (and in
    "qkpv" K5 "qk"'s) must read outside that bound. Timed: the kernel, the
    plain version, K1, sdpa and the bound."""
    from sd_tpu_torch.ops.cuda import (flash_attention, flash_attention_int8,
                                       flash_attention_int8_plain)

    b, n, h, d, mode = shape
    shape = (b, n, h, d)
    scale = d**-0.5
    bf = [randn(*shape).to(torch.bfloat16) for _ in range(3)]
    out = flash_attention_int8(*bf, scale, mode)
    torch.cuda.synchronize()
    unquantized = {"K1": flash_attention(*bf, scale)} if gate else {}
    if gate and mode == "qkpv":
        unquantized["K5 qk"] = flash_attention_int8(*bf, scale, "qk")
    err = check_int8_error(f"K5 {mode}", shape, out,
                           flash_attention_int8_plain(*[t.float() for t in bf], scale, mode),
                           unquantized)
    if not timed:
        return dict(err=err)
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
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bf16_ms=bf16_ms,
                **bnd)


def check_int8_flash(randn) -> list:
    rows = []
    for shape in INT8_FLASH_SHAPES:
        log_plan(f"K5 {shape[4]}", shape[:4])
        rows.append(int8_flash_case(randn, shape))
        free_memory()
    for shape in INT8_FLASH_OFF_PATH:
        log_plan(f"K5 {shape[4]}", shape[:4])
        int8_flash_case(randn, shape, timed=False, gate=False)
    return rows


def int8_dense_case(randn, shape, timed: bool = True) -> dict:
    """K6 at one shape (M, C, F) against its plain version (fp32 on the same
    bf16 inputs) within INT8_TOL["K6"], which bf16 F.linear must fail; raises
    CheckFailed. Timed: the kernel, the plain version, F.linear,
    torch._int_mm on the same codes (the library's int8 product without the
    quantization or the epilogue: a yardstick only) and the bound."""
    from sd_tpu_torch.ops.cuda import int8_dense, int8_dense_plain
    from sd_tpu_torch.ops.cuda.geglu_ff import quantize_cols
    from sd_tpu_torch.ops.quant import quantize_rows

    m, c, f = shape
    x = randn(m, c).to(torch.bfloat16)
    w = (randn(f, c) * c**-0.5).to(torch.bfloat16)
    b = 0.1 * randn(f)
    wq, sw = quantize_cols(w)
    out = int8_dense(x, w, b, prequant=(wq, sw))
    torch.cuda.synchronize()
    bf16_b = b.to(torch.bfloat16)
    err = check_int8_error("K6", shape, out, int8_dense_plain(x.float(), wq, sw, b),
                           {"F.linear": F.linear(x, w, bf16_b)}, scale_floor=1.0)
    if not timed:
        return dict(err=err)
    xq = quantize_rows(x)[0]
    ms = time_ms(lambda: int8_dense(x, w, b, prequant=(wq, sw)))
    plain_ms = time_ms(lambda: int8_dense_plain(x, wq, sw, b))
    bf16_ms = time_ms(lambda: F.linear(x, w, bf16_b))
    int_mm_ms = time_ms(lambda: torch._int_mm(xq, wq.t()))
    bnd = bound(0, m * c * 2 + f * c + f * 8 + m * f * 2, int8_ops=2 * m * c * f)
    log(f"[K6 int8_dense] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bf16 F.linear "
        f"{bf16_ms:.4f} ms, torch._int_mm on the codes {int_mm_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, bf16_ms=bf16_ms,
                int_mm_ms=int_mm_ms, **bnd)


def log_int8_dense_plan(shape) -> None:
    """The plan the library chooses for K6 at (M, C, F)."""
    dense = importlib.import_module("sd_tpu_torch.ops.cuda.int8_dense")
    p = dense.kernel_plan(*shape)
    log(f"[K6 plan] {shape}: {p['rows']} rows x {p['cols']} columns a tile, {p['stages']} "
        f"weight stages, {p['blocks']} blocks ({p['runs']} runs of F, {p['tiles_per_block']} "
        f"tiles a block), {p['smem_bytes']} bytes of shared memory")


def check_int8_dense(randn) -> list:
    rows = []
    for shape in INT8_DENSE_SHAPES:
        log_int8_dense_plan(shape)
        rows.append(int8_dense_case(randn, shape))
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


def _fused_bound(b, c, hw, n, second):
    """K7's least time: its products, and its inputs and outputs once each."""
    px = b * hw * hw
    nbytes = px * c * 2 + 9 * c * n * 2 + 2 * b * c * 4 + px * n * 2
    nbytes += (n * 4 + px * n * 2) if second else 2 * b * n * 4
    return bound(2 * px * 9 * c * n, nbytes)


@torch.no_grad()
def fused_conv_case(randn, shape, timed: bool = True) -> dict:
    """K7 at one launch (B, C, H=W, N, "first" | "second") of the fused
    serving path, as the resnet blocks call it when serving (no autograd,
    the weight repacked beforehand), against its plain version in fp32 on
    the same bf16 inputs (y and the moments); raises CheckFailed. Timed: the
    kernel, the plain version, the unfused site, cuDNN's conv alone on h and
    the bound."""
    from sd_tpu_torch.ops.cuda import fused_conv3x3, fused_conv3x3_plain
    from sd_tpu_torch.ops.cuda.fused_conv import fold_gn_affine, repack_weight
    from sd_tpu_torch.ops.norms import GroupNorm32, group_stats

    b, c, hw, n, launch = shape
    shape = (b, c, hw, hw, n, launch)
    second = launch == "second"
    x = randn(b, c, hw, hw).to(torch.bfloat16)
    w = (randn(n, c, 3, 3) * (9 * c) ** -0.5).to(torch.bfloat16)
    gn = GroupNorm32(c).to(x.device, torch.bfloat16)
    with torch.no_grad():
        gn.weight.copy_(1.0 + 0.1 * randn(c))
        gn.bias.copy_(0.1 * randn(c))
    a, d = fold_gn_affine(*group_stats(x, 32), gn.weight.float(), gn.bias.float(), gn.eps)
    bias = 0.1 * randn(n)
    skip = randn(b, n, hw, hw).to(torch.bfloat16)
    kw = dict(a=a, d=d, bias=bias, skip=skip) if second else dict(a=a, d=d, emit_moments=True)
    wk = repack_weight(w)
    got = fused_conv3x3(x, w, wk=wk, **kw)
    torch.cuda.synchronize()
    ref_kw = dict(kw, skip=skip.float()) if second else kw
    ref = fused_conv3x3_plain(x.float(), w.float(), **ref_kw)
    if second:
        got, ref = (got,), (ref,)
    # the second launch's bound scales with the branch it adds to skip, so
    # that a fault in the conv shows however large the skip is
    err = check_error("K7 fused_conv3x3", shape, got[0], ref[0], scale_floor=1.0,
                      residual=skip if second else None)
    for name, g, r in zip(("sum", "sum of squares"), got[1:], ref[1:]):
        check_error(f"K7 fused_conv3x3 moments {name}", shape, g, r)
    if not timed:
        return dict(err=err)
    bf16_b = bias.to(torch.bfloat16)

    def unfused():
        h = F.conv2d(F.silu(gn(x)), w, bf16_b, padding=1)
        if second:
            return h + skip
        return group_stats(h, 32)

    h = F.silu(gn(x))
    ms = time_ms(lambda: fused_conv3x3(x, w, wk=wk, **kw))
    plain_ms = time_ms(lambda: fused_conv3x3_plain(x, w, **kw), iters=5)
    unfused_ms = time_ms(unfused)
    conv_ms = time_ms(lambda: F.conv2d(h, w, bf16_b, padding=1))
    bnd = _fused_bound(b, c, hw, n, second)
    log(f"[K7 fused_conv3x3] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused "
        f"site {unfused_ms:.4f} ms, cuDNN conv alone {conv_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None, unfused_ms=unfused_ms,
                conv_ms=conv_ms, **bnd)


def log_fused_plan(shape) -> None:
    """The plan the library chooses for K7 at (B, C, H=W, N, launch)."""
    from sd_tpu_torch.ops.cuda.fused_conv import kernel_plan

    b, c, hw, n, _ = shape
    p = kernel_plan(b, c, hw, hw, n)
    log(f"[K7 plan] {shape[:4]}: {p['rows']} x {p['cols']} pixels x {p['channels']} channels "
        f"a block, {p['stages']} weight stages, {p['splits']} split(s) over C of "
        f"{p['steps_per_split']} 64-channel steps, {p['blocks']} blocks, {p['smem_bytes']} "
        f"bytes of shared memory")


def check_fused_conv(randn) -> list:
    """K7 at every launch of the fused serving path, with its gradient."""
    rows = []
    for shape in FUSED_SHAPES:
        log_fused_plan(shape)
        rows.append(fused_conv_case(randn, shape))
        free_memory()
    check_fused_grad(randn)
    return rows


def check_fused_grad(randn) -> None:
    """One gradient through K7's autograd function (bf16 inputs, every
    flag) against the plain backward in fp32 on the same inputs."""
    from sd_tpu_torch.ops.cuda import fused_conv3x3, fused_conv3x3_plain

    b, c, hw, n = 2, 640, 32, 640
    vals = [randn(b, c, hw, hw).to(torch.bfloat16), (randn(n, c, 3, 3) * (9 * c) ** -0.5
                                                      ).to(torch.bfloat16),
            1.0 + 0.1 * randn(b, c), 0.3 * randn(b, c), 0.1 * randn(n),
            randn(b, n, hw, hw).to(torch.bfloat16)]
    gy, g1, g2 = randn(b, n, hw, hw), randn(b, n) * 1e-2, randn(b, n) * 1e-4
    names = ("x", "w", "a", "d", "bias", "skip")

    def grads(fn, leaves):
        x, w, a, d, bias, skip = leaves
        y, s1, s2 = fn(x, w, a, d, bias, skip)
        loss = (y.float() * gy).sum() + (s1 * g1).sum() + (s2 * g2).sum()
        return torch.autograd.grad(loss, leaves)

    leaves = [v.clone().requires_grad_() for v in vals]
    got = grads(lambda x, w, a, d, bias, skip: fused_conv3x3(
        x, w, a=a, d=d, bias=bias, skip=skip, emit_moments=True), leaves)
    ref_leaves = [v.float().requires_grad_() for v in vals]
    want = grads(lambda *t: fused_conv3x3_plain(*t, emit_moments=True), ref_leaves)
    torch.cuda.synchronize()
    for name, g, r in zip(names, got, want):
        rel = ((g.float() - r).norm() / r.norm()).item()
        ok = bool(torch.isfinite(g).all()) and rel <= FUSED_GRAD_TOL
        log(f"[K7 gradient] d{name}: relative L2 {rel:.3e} against the plain backward in fp32 "
            f"(bound {FUSED_GRAD_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"K7 gradient d{name}: relative L2 {rel}")


def log_winograd_plan(label: str, x_shape, k: int, split: bool) -> None:
    """The launch plan the library chooses for K8 or X3 at this shape."""
    from sd_tpu_torch.ops.cuda.winograd_conv import kernel_plan

    plan = kernel_plan(x_shape, k, split)
    slots = plan["blocks_per_sm"] * torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[{label} plan] {tuple(x_shape)}->{k}: plan {plan['plan']}, "
        f"{plan['tile_rows']} x {plan['tile_cols']} tiles and {plan['channels']} channels a "
        f"block, {plan['channel_step']} input channels a step, {plan['threads']} threads, "
        f"{plan['smem_bytes']} bytes of shared memory, {plan['blocks_per_sm']} blocks per SM; "
        f"{plan['blocks']} blocks, {plan['blocks'] / slots:.2f} waves")


def winograd_case(randn, shape, timed: bool = True) -> dict:
    """K8 and X3 at one shape (B, C, H, W, K), given U (the weight transform
    rounded to bf16, as Conv3x3 keeps it), against their plain version (fp32
    on the same bf16 inputs) and against F.conv2d in fp32; raises
    CheckFailed on either. Timed: each kernel's ms with U given, the whole
    wrapper's ms (U computed in the call), the plain version's, F.conv2d's
    in bf16 and the bound."""
    from sd_tpu_torch.ops.cuda import (winograd_conv3x3, winograd_conv3x3_plain,
                                       winograd_conv3x3_split)
    from sd_tpu_torch.ops.cuda.winograd_conv import weight_transform

    b, c, h, wd, k = shape
    x = randn(b, c, h, wd).to(torch.bfloat16)
    w = (randn(k, c, 3, 3) * (9 * c) ** -0.5).to(torch.bfloat16)
    u = weight_transform(w).to(torch.bfloat16).contiguous()
    ref = winograd_conv3x3_plain(x.float(), w.float())
    direct = F.conv2d(x.float(), w.float(), padding=1)
    rows = {}
    for name, fn, label in (("winograd_conv3x3", winograd_conv3x3, "K8"),
                            ("winograd_conv3x3_split", winograd_conv3x3_split, "X3")):
        got = fn(x, w, u=u)
        torch.cuda.synchronize()
        err = check_error(f"{label} {name}", shape, got, ref)
        check_error(f"{label} {name} against F.conv2d", shape, got, direct)
        rows[name] = dict(err=err)
    if not timed:
        return rows
    plain_ms = time_ms(lambda: winograd_conv3x3_plain(x, w), iters=5)
    library_ms = time_ms(lambda: F.conv2d(x, w, padding=1))
    bnd = bound(2 * b * (h // 2) * (wd // 2) * 16 * c * k,
                b * c * h * wd * 2 + 9 * c * k * 2 + b * k * h * wd * 2)
    for name, fn, label in (("winograd_conv3x3", winograd_conv3x3, "K8"),
                            ("winograd_conv3x3_split", winograd_conv3x3_split, "X3")):
        log_winograd_plan(label, x.shape, k, name.endswith("split"))
        ms = time_ms(lambda: fn(x, w, u=u))
        call_ms = time_ms(lambda: fn(x, w))
        log(f"[{label} {name}] {shape}: kernel {ms:.4f} ms (U given), whole call {call_ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, F.conv2d {library_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows[name].update(ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
                          **bnd)
    return rows


def check_winograd(randn) -> dict:
    """K8 and X3 at every K8 site of the serving path and at the X3
    experiment's levels (the rows of the kernels line), then at the ragged
    shapes of WINO_RAGGED (checked and timed, not summed)."""
    rows = {"winograd_conv3x3": [], "winograd_conv3x3_split": []}
    for b, c, hw, k in WINO_SHAPES + X3_LEVELS:
        for name, row in winograd_case(randn, (b, c, hw, hw, k)).items():
            rows[name].append(row)
    for shape in WINO_RAGGED:
        winograd_case(randn, shape)
    return rows


def x3_experiment() -> dict:
    """The X3 experiment path (tools/exp_winograd.py's timing_split): one
    in-kernel-split Winograd conv at each UNet level at B=16, against the
    direct conv; returns the launch counts of that run."""
    from sd_tpu_torch.ops.cuda import winograd_conv3x3_split

    g = torch.Generator(device="cuda").manual_seed(2)
    reset_launches()
    for b, c, hw, k in X3_LEVELS:
        x = torch.randn((b, c, hw, hw), generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((k, c, 3, 3), generator=g, device="cuda") * 0.02).to(torch.bfloat16)
        got = winograd_conv3x3_split(x, w)
        check_error("X3 experiment", (b, c, hw, hw, k), got, F.conv2d(x.float(), w.float(),
                                                                       padding=1))
    counts = read_launches()
    want = expect(winograd_conv3x3_split=len(X3_LEVELS))
    log(f"[X3 experiment] launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError(f"X3 experiment launches {counts} != {want}")
    return counts


def _block_bound(b, n, c, heads):
    """X1's least time: the tool's CostEstimate flops, x read and the output
    written once, the four weights and three vectors read once."""
    d = c // heads
    nbytes = 2 * b * n * c * 2 + 4 * c * c * 2 + 3 * c * 4
    return bound(8 * b * n * c * c + 4 * b * heads * n * n * d, nbytes)


def _tail_bound(b, n, c, heads, inner, kv_len):
    """X2's least time: the tool's CostEstimate flops plus QKᵀ and P·V over
    kv_len keys; x, the live kc/vc rows, the weights and vectors read once,
    the output written once."""
    nbytes = (2 * b * n * c + 2 * b * kv_len * c + 2 * c * c + 3 * c * inner) * 2
    nbytes += (6 * c + 2 * inner) * 4
    return bound(4 * b * n * c * c + 6 * b * n * c * inner + 4 * b * n * kv_len * c, nbytes)


def _fp32(args: dict) -> dict:
    return {k: v.float() if torch.is_tensor(v) else v for k, v in args.items()}


def check_x1_site(n: int, c: int):
    """X1 on the experiment's inputs at (N, C), B=16, against its plain
    version in fp32, within KERNEL_TOL of the branch's max; returns (x, the
    keyword arguments, the max abs error)."""
    from sd_tpu_torch.ops.cuda import fused_block, fused_block_plain
    from sd_tpu_torch.scripts import exp_block_kernel as exp

    x, args = exp.block_inputs(n, c, "cuda", seed=n)
    got = fused_block(x, **args)
    torch.cuda.synchronize()
    err = check_error("X1 fused_block", tuple(x.shape), got,
                      fused_block_plain(x.float(), **_fp32(args)), residual=x)
    return x, args, err


def check_x2_site(n: int, c: int):
    """X2 as :func:`check_x1_site`, every context row non-zero: only the mask
    keeps rows >= kv_len out."""
    from sd_tpu_torch.ops.cuda import tail_fused, tail_fused_plain
    from sd_tpu_torch.scripts import exp_block_kernel as exp

    x, args = exp.tail_inputs(n, c, "cuda", seed=n + 1)
    got = tail_fused(x, **args)
    torch.cuda.synchronize()
    err = check_error("X2 tail_fused", tuple(x.shape), got,
                      tail_fused_plain(x.float(), **_fp32(args)), residual=x)
    return x, args, err


def check_block_kernels() -> dict:
    """X1 and X2 at SD v1's four transformer sites at B=16 against their
    plain versions (fp32 on the same bf16 inputs), beside the unfused
    yardstick; then X1∘X2 on a port BasicTransformerBlock against the block."""
    from sd_tpu_torch.ops.attention import BasicTransformerBlock
    from sd_tpu_torch.ops.cuda import (fused_block, fused_block_plain, tail_fused,
                                       tail_fused_plain)
    from sd_tpu_torch.scripts import exp_block_kernel as exp
    from sd_tpu_torch.utils.config import init_random_

    g = torch.Generator(device="cuda").manual_seed(4)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    b, heads, kv_len = exp.B, exp.HEADS, exp.KV_LEN
    rows = {"fused_block": [], "tail_fused": []}
    for n, c in BLOCK_SITES:
        shape = (b, n, c)
        x, args, err = check_x1_site(n, c)
        mods = exp.self_attention_modules(**args, dtype=x.dtype)
        ms = time_ms(lambda: fused_block(x, **args))
        plain_ms = time_ms(lambda: fused_block_plain(x, **args), iters=3, warmup=1)
        unfused_ms = time_ms(lambda: exp.unfused_block(x, *mods))
        bnd = _block_bound(b, n, c, heads)
        log(f"[X1 fused_block] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused "
            f"{unfused_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows["fused_block"].append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                                        unfused_ms=unfused_ms, **bnd))

        x, args, err = check_x2_site(n, c)
        kc, vc = args["kc"], args["vc"]
        weights = {k: v for k, v in args.items() if k not in ("kc", "vc", "kv_len")}
        mods = exp.tail_modules(**weights, dtype=x.dtype)
        ms = time_ms(lambda: tail_fused(x, **args))
        plain_ms = time_ms(lambda: tail_fused_plain(x, **args), iters=3, warmup=1)
        unfused_ms = time_ms(lambda: exp.tail_unfused(x, kc, vc, kv_len, *mods))
        bnd = _tail_bound(b, n, c, heads, 4 * c, kv_len)
        log(f"[X2 tail_fused] {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused "
            f"{unfused_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
        rows["tail_fused"].append(dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                                       unfused_ms=unfused_ms, **bnd))

        block = BasicTransformerBlock(c, heads, c // heads, context_dim=CONTEXT_DIM)
        init_random_(block, torch.Generator().manual_seed(n))
        block = block.to("cuda", torch.bfloat16).eval()
        x = randn(b, n, c).to(torch.bfloat16)
        ctx = randn(b, kv_len, CONTEXT_DIM).to(torch.bfloat16)
        with torch.no_grad():
            fused = exp.fused_transformer_block(block, x, ctx)
            want = block(x, ctx)
        rel = exp.relative_l2(fused, want)
        ok = bool(torch.isfinite(fused).all()) and rel <= BLOCK_AGREEMENT_TOL
        log(f"[X1∘X2 block] {shape}: a port BasicTransformerBlock through X1 and X2 against the "
            f"block, bf16: relative L2 {rel:.3e} (bound {BLOCK_AGREEMENT_TOL}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"X1∘X2 at {shape}: relative L2 {rel}")
        del x, args, mods, block, kc, vc, weights
        free_memory()
    return rows


def block_experiment() -> dict:
    """The block experiment's two entry points at their defaults, through
    main(); exact launches of each; returns the counts of both runs."""
    from sd_tpu_torch.scripts import exp_block_kernel as exp

    per_step = 2 + exp.REPS * exp.ITERS  # the check, the warm-up step, the chained runs
    total = {}
    for argv, want in (([], expect(fused_block=per_step, flash_attention=per_step)),
                       (["tail"], expect(tail_fused=per_step, geglu_ff=per_step))):
        reset_launches()
        result = exp.main(argv)
        counts = read_launches()
        log(f"[block experiment] {' '.join(['exp_block_kernel', *argv])}: {result}; launches "
            f"{counts}, expected {want}")
        if counts != want:
            raise AssertionError(f"block experiment {argv}: launches {counts} != {want}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


def check_conv_kernels() -> dict:
    g = torch.Generator(device="cuda").manual_seed(3)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    timings = {"fused_conv3x3": check_fused_conv(randn)}
    timings.update(check_winograd(randn))
    return timings


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


def check_fp32_reference() -> None:
    """The fp32 opt-out on the card. SD_TPU_PRECISION=fp32 builds the tiny
    model in fp32; with the CPU model's weights it samples (PLMS 5) against
    the fp32 CPU run. Then one tiny training loss and its UNet gradients in
    fp32 outside autocast against the CPU. TF32 is off for matmul and cuDNN
    (main() sets both). Neither run may launch K1, K2 or K3, whose kernels
    are bf16: the plain versions serve fp32."""
    from sd_tpu_torch.data.base import collate
    from sd_tpu_torch.data.synthetic import SyntheticImages
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.training.diffusion_loss import LDMTrainer
    from sd_tpu_torch.utils.config import build_latent_diffusion, train_config

    cpu_pipe, hw = build_txt2img_pipeline(tiny=True, device="cpu", seed=0, watermark=False)
    before = os.environ.get("SD_TPU_PRECISION")
    os.environ["SD_TPU_PRECISION"] = "fp32"
    try:
        card_pipe, _ = build_txt2img_pipeline(tiny=True, device="cuda", seed=0, watermark=False)
    finally:
        if before is None:
            del os.environ["SD_TPU_PRECISION"]
        else:
            os.environ["SD_TPU_PRECISION"] = before
    dtypes = {p.dtype for p in card_pipe.ldm.parameters()}
    if dtypes != {torch.float32}:
        raise AssertionError(f"SD_TPU_PRECISION=fp32 built the model in {dtypes}")
    card_pipe.ldm.load_state_dict(cpu_pipe.ldm.state_dict())
    x_T = np.random.default_rng(0).standard_normal((2, hw // 2, hw // 2, 4)).astype(np.float32)
    run = dict(height=hw, width=hw, steps=5, guidance_scale=7.5)
    prompts = [PROMPT, "a red cube"]
    cpu_pipe(prompts, x_T=torch.from_numpy(x_T), **run)
    reset_launches()
    card_pipe(prompts, x_T=torch.from_numpy(x_T).cuda(), **run)
    sampled = read_launches()
    want = cpu_pipe.last_latents
    got = card_pipe.last_latents.cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[fp32 reference] tiny model, SD_TPU_PRECISION=fp32 on the card vs fp32 CPU, PLMS 5: "
        f"latents {got.dtype}, max |diff| / max |ref| = {rel:.3e} (bound {FP32_TOL}); "
        f"launches {sampled}")
    if got.dtype != torch.float32 or not (np.isfinite(rel) and rel <= FP32_TOL):
        raise AssertionError(f"the fp32 tiny model disagrees with its CPU run: {rel}")

    cpu_ldm = build_latent_diffusion(train_config(tiny=True)["model"], device="cpu", seed=0)
    trainers = [LDMTrainer(ldm=ldm, base_lr=1e-3, use_ema=False)
                for ldm in (cpu_ldm, copy.deepcopy(cpu_ldm).cuda())]
    for trainer in trainers:
        trainer.init_state()
    batch = collate([SyntheticImages(size=128, length=2)[i] for i in range(2)])
    t = torch.from_numpy(np.array([17, 633]))
    noise = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 4, 64, 64)).astype(np.float32))
    want_loss, want = _tiny_loss_and_grads(trainers[0], batch, t, noise, autocast=False)
    reset_launches()
    got_loss, got = _tiny_loss_and_grads(trainers[1], batch, t, noise, autocast=False)
    trained = read_launches()
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    diff = sum((got[n] - want[n]).square().sum() for n in want).sqrt().item()
    norm = sum(want[n].square().sum() for n in want).sqrt().item()
    log(f"[fp32 reference] tiny training step at 128², fp32 outside autocast on the card vs "
        f"the CPU: loss {got_loss:.6f} vs {want_loss:.6f} (relative {loss_rel:.3e}), UNet "
        f"gradients relative L2 {diff / norm:.3e} (bound {FP32_TOL} each); launches "
        f"{trained}")
    if not (loss_rel <= FP32_TOL and diff / norm <= FP32_TOL):
        raise AssertionError("the fp32 training step disagrees with its CPU run")
    for counts in (sampled, trained):
        if any(counts[k] for k in ("flash_attention", "geglu_ff", "flash_attention_bwd")):
            raise AssertionError(f"an fp32 run launched a bf16 kernel: {counts}")


# the small UNet of tests/test_torch_conv_modes.py: every resnet block
# passes K7's gate, and the 32² upsample conv K8's
SMALL_UNET = dict(image_size=32, in_channels=4, out_channels=4, model_channels=128,
                  attention_resolutions=[2], num_res_blocks=1, channel_mult=[1, 2], num_heads=4,
                  use_spatial_transformer=True, transformer_depth=1, context_dim=32)


def check_conv_modes_reference() -> None:
    """The small UNet with both conv modes, bf16 on the card, against the
    same weights in fp32 on the CPU (plain versions)."""
    from sd_tpu_torch.models.unet import UNetConfig, UNetModel
    from sd_tpu_torch.ops.resblock import set_conv_modes
    from sd_tpu_torch.utils.config import init_random_

    cpu = UNetModel(UNetConfig.from_dict(SMALL_UNET)).eval()
    init_random_(cpu, torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to("cuda", torch.bfloat16)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 4, 32, 32)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 8, 32)).astype(np.float32))
    t = torch.tensor([17, 633])
    with torch.no_grad():
        want = cpu(x, t, ctx)
        bf16 = card(x.cuda(), t.cuda(), ctx.cuda()).float().cpu()
        set_conv_modes(card, "1", "winograd")
        reset_launches()
        got = card(x.cuda(), t.cuda(), ctx.cuda()).float().cpu()
        counts = read_launches()
    rel = lambda a: ((a - want).abs().max() / want.abs().max()).item()
    moved = ((got - bf16).norm() / bf16.norm()).item()
    log(f"[conv modes reference] small UNet, both modes in bf16 on the card vs fp32 on the CPU: "
        f"max |diff| / max |ref| = {rel(got):.3e} (bound {CONV_MODES_TOL}); the card's bf16 run "
        f"without the modes {rel(bf16):.3e}, {moved:.3e} (relative L2) from the modes' run; "
        f"launches {counts}")
    if counts["fused_conv3x3"] != 16 or counts["winograd_conv3x3"] != 1:
        raise AssertionError(f"the small UNet did not take K7 16 times and K8 once: {counts}")
    if torch.equal(got, bf16):
        raise AssertionError("the small UNet's output did not change with the conv modes")
    if not (np.isfinite(rel(got)) and rel(got) <= CONV_MODES_TOL):
        raise AssertionError(f"small UNet with the conv modes disagrees: {rel(got)}")


def _counted():
    """Every launch counter: the eleven kernels, K5's "qkpv" share, and the
    int8 conv's calls on the card."""
    from sd_tpu_torch.ops import cuda
    from sd_tpu_torch.ops.quant import int8_conv3x3

    return {"flash_attention": cuda.flash_attention, "geglu_ff": cuda.geglu_ff,
            "flash_attention_bwd": cuda.flash_attention_bwd,
            "geglu_ff_int8": cuda.geglu_ff_int8, "flash_attention_int8": cuda.flash_attention_int8,
            "int8_dense": cuda.int8_dense, "int8_conv3x3": int8_conv3x3,
            "fused_conv3x3": cuda.fused_conv3x3, "winograd_conv3x3": cuda.winograd_conv3x3,
            "winograd_conv3x3_split": cuda.winograd_conv3x3_split,
            "fused_block": cuda.fused_block, "tail_fused": cuda.tail_fused}


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
    pipe, _ = build_txt2img_pipeline(device="cuda", seed=0, watermark=False, int8=int8,
                                     fused_conv="auto", conv_impl="auto")
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
    return out, pipe


def serve_conv_modes(pipe, bf16: dict) -> dict:
    """SD v1 with each conv mode and with both: one request each with the
    bf16 phase's generator 0, exact K7 and K8 counts, K1 and K2 as in bf16,
    latents within AGREEMENT_TOL of the bf16 request 0's."""
    s1 = STEPS + 1
    k7 = 2 * (FUSED_BLOCKS["unet"] * s1 + FUSED_BLOCKS["decoder"])
    k8 = WINO_SITES["unet"] * s1 + WINO_SITES["decoder"]
    k8_beside = WINO_SITES_BESIDE_FUSED["unet"] * s1 + WINO_SITES_BESIDE_FUSED["decoder"]
    runs = (("1", "auto", dict(fused_conv3x3=k7)), ("auto", "winograd", dict(winograd_conv3x3=k8)),
            ("1", "winograd", dict(fused_conv3x3=k7, winograd_conv3x3=k8_beside)))
    total, seconds = {}, []
    z16 = bf16["latents"][0]
    for fused, impl, counts in runs:
        pipe.ldm.set_conv_modes(fused, impl)
        label = f"bf16, SD_TPU_FUSED_CONV={fused}, SD_TPU_CONV_IMPL={impl}"
        out = serve(pipe, label, 1, 1, expect(
            flash_attention=SITES_PER_UNET * s1 + 1, geglu_ff=SITES_PER_UNET * s1, **counts))
        z = out["latents"][0]
        rel = ((z - z16).norm() / z16.norm()).item()
        log(f"[serve {label}] agreement: latents against the bf16 request 0, relative L2 "
            f"{rel:.5f} (bound {AGREEMENT_TOL}); identical: {torch.equal(z, z16)}; "
            f"{out['seconds'][0]:.3f} s against bf16's {bf16['seconds'][0]:.3f} s")
        if not (np.isfinite(rel) and rel < AGREEMENT_TOL) or torch.equal(z, z16):
            raise AssertionError(f"{label} disagrees with bf16: relative L2 {rel}")
        seconds.append(out["seconds"][0])
        for k, v in out["launches"].items():
            total[k] = total.get(k, 0) + v
    pipe.ldm.set_conv_modes("auto", "auto")
    again = serve(pipe, "bf16, after the conv modes", 1, 1, expect(
        flash_attention=SITES_PER_UNET * s1 + 1, geglu_ff=SITES_PER_UNET * s1))
    log(f"[serve] per request: bf16 {' '.join(f'{t:.3f}' for t in bf16['seconds'])} s, then the "
        f"conv modes (fused, winograd, both) {' '.join(f'{t:.3f}' for t in seconds)} s, then "
        f"bf16 {again['seconds'][0]:.3f} s")
    for k, v in again["launches"].items():
        total[k] += v
    return total


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


def _tiny_loss_and_grads(trainer, batch, t, noise, autocast: bool = True):
    """One loss of ``p_losses`` and the UNet gradients, with the batch's
    latents at the posterior's mode and the given t and noise; under the
    trainer's autocast, or outside any."""
    from sd_tpu_torch.training.diffusion_loss import p_losses

    ldm, device = trainer.ldm, trainer.device
    scope = trainer.autocast if autocast else contextlib.nullcontext
    x = torch.from_numpy(batch["image"]).to(device).permute(0, 3, 1, 2)
    tokens = torch.from_numpy(batch["caption"]).to(device).long()
    trainer.unet.zero_grad(set_to_none=True)
    with torch.no_grad(), scope():
        z = ldm.encode_to_latent(x).float()
        cond = ldm.get_learned_conditioning(tokens)
    with scope():
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
    timings.update(check_conv_kernels())
    free_memory()
    timings.update(check_block_kernels())
    check_reference()
    check_fp32_reference()
    free_memory()
    check_int8_reference()
    check_conv_modes_reference()
    x3_launches = x3_experiment()
    block_launches = block_experiment()
    free_memory()
    served, pipe = serve_main_path()
    served_conv = serve_conv_modes(pipe, served)
    del pipe
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
                             "sd_tpu/ops/pallas/int8_dense.py:66"),
              "fused_conv3x3": ("sd_tpu_torch/csrc/fused_conv.cu",
                                "sd_tpu/ops/pallas/fused_conv.py:300"),
              "winograd_conv3x3": ("sd_tpu_torch/csrc/winograd_conv.cu",
                                   "sd_tpu/ops/pallas/winograd_conv.py:174"),
              "winograd_conv3x3_split": ("sd_tpu_torch/csrc/winograd_conv.cu",
                                         "tools/exp_winograd.py:271"),
              "fused_block": ("sd_tpu_torch/csrc/fused_block.cu", "tools/exp_block_kernel.py:91"),
              "tail_fused": ("sd_tpu_torch/csrc/tail_fused.cu", "tools/exp_block_kernel.py:244")}
    runs = (served["launches"], served_int8, trained, served_conv, x3_launches, block_launches)
    kernels = []
    for k, rows in timings.items():
        library = [r["library_ms"] for r in rows]
        ops_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        kernels.append({
            "name": k, "route": "cuda", "source": source[k][0], "replaces": source[k][1],
            "launches": sum(run[k] for run in runs),
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
