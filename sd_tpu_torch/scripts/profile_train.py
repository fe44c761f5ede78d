"""Profile SD v1 training steps on the card, by kernel.

    python -m sd_tpu_torch.scripts.profile_train

Builds the trainer as ``python -m sd_tpu_torch.scripts.train`` does (SD v1 at
full width, batch 4 of 512² synthetic images, seeded random weights), runs
3 warm-up steps, times 3 steps with the profiler off (host clock after a
device sync), then traces 3 more with ``torch.profiler`` and prints, per
step: the wall time, the device busy time (the union of kernel intervals)
and so the card's idle share, the kernel count, the device time of each
kernel group, and the 12 costliest kernels. Needs a card; there is no CPU
mode.
"""

from __future__ import annotations

import subprocess
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WARMUP = 3
STEPS = 3
TOP = 12

# (group, substrings of the kernel name), first match wins
GROUPS: List[Tuple[str, Tuple[str, ...]]] = [
    ("K1 flash_attention", ("flash_fwd_kernel",)),
    ("K3 flash_attention_bwd", ("flash_bwd_",)),
    ("K5 flash_attention_int8", ("int8_attn_kernel", "flash_int8_kernel", "quant_heads_kernel",
                                 "quant_v_kernel")),
    ("K2 geglu_ff", ("geglu_gemm_kernel", "geglu_splitk_reduce", "gemm_nt_kernel")),
    # K6: its kernels, and its first design's instance of K4's GEMM (quantizing A,
    # bf16 out)
    ("K6 int8_dense", ("int8_dense_kernel", "int8_dense_quant_kernel",
                       "int8_gemm_kernel<true, (sdt_i8::(anonymous namespace)::Epi)0>")),
    ("K4 geglu_ff_int8", ("int8_gemm_kernel", "quant_rows_kernel")),
    ("K7 fused_conv3x3", ("fused_conv_kernel", "fused_conv_reduce_kernel")),
    ("K8/X3 winograd_conv3x3", ("winograd_kernel<",)),
    ("AdamW (multi-tensor)", ("multi_tensor_apply",)),
    ("convs (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit_", "winograd")),
    ("matmul (cuBLAS)", ("gemm", "cutlass", "xmma", "nvjet", "splitK")),
    ("copies, casts, cat", ("copy", "Copy", "cat", "Memcpy", "Memset", "fill")),
    ("norms and softmax", ("norm", "softmax")),
    ("reductions", ("reduce", "Reduce")),
]


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "elementwise and other"


def _busy_us(intervals: List[Tuple[float, float]]) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device is available")

    from sd_tpu_torch.scripts.train import build_trainer, parse_args
    from sd_tpu_torch.training.trainer import step_seed

    harness, state, data = build_trainer(parse_args(
        ["--logdir", tempfile.mkdtemp(prefix="profile_train_"), "--seed", "0"]))
    trainer = harness.trainer_obj
    batches = iter(data.train_dataloader())

    def step() -> None:
        generator = torch.Generator("cuda").manual_seed(step_seed(0, state.step))
        trainer.train_step(state, next(batches), generator)

    for _ in range(WARMUP):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
    # device activity only: kernels, copies and sets, not the user annotations
    # (such as the optimizer step's range) that the trace also puts on the card
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and getattr(e, "activity_type", None) != "gpu_user_annotation"]
    if not kernels:
        raise SystemExit("profile_train: the profiler recorded no device time")
    per_group: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    per_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        for totals in (per_group[group_of(e.name)], per_name[e.name]):
            totals[0] += e.time_range.elapsed_us()
            totals[1] += 1
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    busy_ms /= STEPS
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    name = torch.cuda.get_device_name(0)
    print(f"{name}; SD v1 training step, batch {data.batch_size} at 512²: wall {wall_ms:.1f} ms "
          f"per step (profiler off, {STEPS} steps after {WARMUP}); device busy "
          f"{busy_ms:.1f} ms per step (profiler on), idle share {1 - busy_ms / wall_ms:.1%}; "
          f"{len(kernels) / STEPS:.0f} kernels per step; peak memory allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"{'kernels':<26} {'ms/step':>9} {'share':>7} {'count/step':>11}")
    for group, (us, count) in sorted(per_group.items(), key=lambda kv: -kv[1][0]):
        ms = us / 1e3 / STEPS
        print(f"{group:<26} {ms:9.3f} {ms / busy_ms:7.1%} {count / STEPS:11.0f}")
    print(f"the {TOP} costliest kernels (ms/step, count/step, group, name):")
    for kname, (us, count) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {us / 1e3 / STEPS:9.3f} {count / STEPS:6.0f}  {group_of(kname):<24} "
              f"{kname[:110]}")


if __name__ == "__main__":
    main()
