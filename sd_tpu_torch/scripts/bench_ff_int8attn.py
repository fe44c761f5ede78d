"""Time K2 (the GEGLU feed-forward) and K5 (int8 attention), and serving
at batch 8 in bf16 and in the int8 mode, for one tree of the repository.

    PYTHONPATH=<tree> python3 sd_tpu_torch/scripts/bench_ff_int8attn.py [label]

``sd_tpu_torch`` is imported from ``PYTHONPATH``, so the same script times
another tree of the repository (a parent commit unpacked under the
git-ignored ``build/``) as well as this one; the shapes, ``time_ms`` and the
yardsticks are read from this file's repository's ``chip_smoke.py``, and the
profiler's kernel groups from its ``profile_train.py``. On the card, with
its name and power limit, it prints:

- K2 at every shape of ``FF_SHAPES``, ms per call (CUDA events, 20 calls
  after 3 warm-up), beside the unfused bf16 FF (five cuBLAS and elementwise
  calls);
- K5 at every shape of ``INT8_FLASH_SHAPES``, beside K1 and
  ``scaled_dot_product_attention``;
- SD v1 serving at batch 8 (512², PLMS 50, guidance 7.5, seeded random
  weights) in turns after one warm-up request of each: bf16, ``SD_TPU_INT8``'s
  "all" twice, bf16: images/s and ms per UNet evaluation; then, under one
  ``torch.profiler`` session, ``PROFILED`` K5 calls at each shape of
  ``INT8_FLASH_SHAPES`` (the device ms of its Q/K/V quantization pre-pass
  and of the attention kernel, the pre-pass being the most that quantizing
  Q and K inside the attention could save) and ``PROFILED`` UNet
  evaluations at B=16 in each mode: wall and device-busy ms per evaluation,
  the idle share and the device ms by kernel group (K2's and K5's among
  them);

then one JSON line of all of it, last. Needs a card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
PROFILED = 3
PAUSE_S = 0.2
MODES = ("off", "all")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_kernels(smoke) -> dict:
    from sd_tpu_torch.ops.cuda import (flash_attention, flash_attention_int8, geglu_ff)

    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    ff = {}
    for m, c, inner in smoke.FF_SHAPES:
        args = [randn(m, c), randn(2 * inner, c) * c**-0.5, 0.1 * randn(2 * inner),
                randn(c, inner) * inner**-0.5, 0.1 * randn(c)]
        bf = [a.to(torch.bfloat16) if a.ndim == 2 else a for a in args]
        row = {"K2_ms": smoke.time_ms(lambda: geglu_ff(*bf)),
               "unfused_ms": smoke.time_ms(lambda: smoke.unfused_ff(*bf))}
        ff["x".join(map(str, (m, c, inner)))] = row
        print(f"[K2] {(m, c, inner)}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
        del args, bf
        smoke.free_memory()
    attn = {}
    for b, n, h, d, mode in smoke.INT8_FLASH_SHAPES:
        bf = [randn(b, n, h, d).to(torch.bfloat16) for _ in range(3)]
        scale = d**-0.5
        row = {"K5_ms": smoke.time_ms(lambda: flash_attention_int8(*bf, scale, mode)),
               "K1_ms": smoke.time_ms(lambda: flash_attention(*bf, scale)),
               "sdpa_ms": smoke.time_ms(lambda: smoke.sdpa(*bf, scale))}
        attn["x".join(map(str, (b, n, h, d))) + f" {mode}"] = row
        print(f"[K5 {mode}] {(b, n, h, d)}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
        del bf
        smoke.free_memory()
    return {"K2": ff, "K5": attn}


def time_serving(smoke) -> dict:
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline

    pipe, _ = build_txt2img_pipeline(device="cuda", seed=0, watermark=False, int8="all",
                                     safety=False, fused_conv="auto", conv_impl="auto")

    def request(mode: str) -> dict:
        pipe.ldm.set_int8_mode(mode)
        gen = torch.Generator(device="cuda").manual_seed(0)
        pipe([smoke.PROMPT] * smoke.BATCH8, gen, height=512, width=512, steps=smoke.STEPS,
             guidance_scale=7.5)
        t = pipe.last_timings
        return {"mode": mode, "s": t["total_s"], "images_per_s": smoke.BATCH8 / t["total_s"],
                "ms_per_unet_eval": t["sample_s"] * 1e3 / (smoke.STEPS + 1)}

    for mode in MODES:
        request(mode)
    turns = [request(mode) for mode in ("off", "all", "all", "off")]
    for turn in turns:
        print(json.dumps(turn), flush=True)
    split = profile(pipe.ldm, smoke)
    print(json.dumps(split), flush=True)
    del pipe
    smoke.free_memory()
    return {"requests_b8": turns, "profile": split}


def profile(ldm, smoke) -> dict:
    """One profiler session (a second session in one process once
    recorded no device events) over segments split at a pause after each:
    ``PROFILED`` K5 calls at each shape of ``INT8_FLASH_SHAPES``, then
    ``PROFILED`` UNet evaluations at B=16 in each int8 mode, as
    ``bench_winograd.profile_modes`` does for the conv modes. Per K5 shape:
    the device ms per call of the quantization pre-pass and of the
    attention. Per mode: wall ms per evaluation (host clock after a sync,
    before the profiler starts), device-busy ms, the idle share and the
    device ms by kernel group."""
    from sd_tpu_torch.ops.cuda import flash_attention_int8
    from sd_tpu_torch.scripts.profile_train import _busy_us, group_of

    g = torch.Generator(device="cuda").manual_seed(0)
    args = (torch.randn((16, 4, 64, 64), generator=g, device="cuda").to(torch.bfloat16),
            torch.full((16,), 500, device="cuda", dtype=torch.long),
            torch.randn((16, 77, 768), generator=g, device="cuda").to(torch.bfloat16))
    segments = []
    for b, n, h, d, mode in smoke.INT8_FLASH_SHAPES:
        qkv = [torch.randn((b, n, h, d), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3)]
        segments.append((f"K5 {b}x{n}x{h}x{d} {mode}",
                         lambda qkv=qkv, mode=mode: flash_attention_int8(*qkv, mode=mode)))

    def unet(mode):
        ldm.set_int8_mode(mode)
        return lambda: ldm.apply_model(*args)

    wall_ms = {}
    with torch.no_grad():
        for mode in MODES:
            run = unet(mode)
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILED):
                run()
            torch.cuda.synchronize()
            wall_ms[mode] = (time.perf_counter() - t0) * 1e3 / PROFILED
        for _, run in segments:
            run()
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for label, run in segments + [(mode, None) for mode in MODES]:
                run = run or unet(label)
                for _ in range(PROFILED):
                    run()
                torch.cuda.synchronize()
                time.sleep(PAUSE_S)
    labels = [label for label, _ in segments] + list(MODES)
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and getattr(e, "activity_type", None) != "gpu_user_annotation"),
                     key=lambda e: e.time_range.start)
    gaps = sorted(range(1, len(kernels)), key=lambda i: kernels[i].time_range.start
                  - kernels[i - 1].time_range.end)[len(kernels) - len(labels):]
    cuts = [0, *sorted(gaps), len(kernels)]
    out = {}
    for label, lo, hi in zip(labels, cuts, cuts[1:]):
        part = kernels[lo:hi]
        if label not in MODES:
            quant = sum(e.time_range.elapsed_us() for e in part if "quant_" in e.name)
            total = sum(e.time_range.elapsed_us() for e in part)
            out[label] = {"quant_ms": quant / 1e3 / PROFILED,
                          "attention_ms": (total - quant) / 1e3 / PROFILED}
            continue
        busy = _busy_us([(e.time_range.start, e.time_range.end) for e in part]) / 1e3 / PROFILED
        groups = {}
        for e in part:
            key = group_of(e.name)
            groups[key] = groups.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / PROFILED
        out[label] = {"wall_ms": wall_ms[label], "busy_ms": busy,
                      "idle_share": 1 - busy / wall_ms[label], "kernels": len(part) / PROFILED,
                      "group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_ff_int8attn: no CUDA device is available")
    import sd_tpu_torch

    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    # the profiler's kernel groups of this repository (they name K2's and
    # K5's kernels of both designs), whichever tree is timed
    sys.modules["sd_tpu_torch.scripts.profile_train"] = _load(
        "profile_train", ROOT / "sd_tpu_torch" / "scripts" / "profile_train.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"label": sys.argv[1] if len(sys.argv) > 1 else "",
              "package": str(Path(sd_tpu_torch.__file__).parent), "card": smi}
    print(smi, flush=True)
    result["kernels"] = time_kernels(smoke)
    result["serving"] = time_serving(smoke)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
