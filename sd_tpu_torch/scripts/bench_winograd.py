"""Time K8 and X3 and the Winograd conv mode, for one tree of the repository.

    PYTHONPATH=<tree> python3 sd_tpu_torch/scripts/bench_winograd.py [label]

``sd_tpu_torch`` is imported from ``PYTHONPATH``, so the same script times
another tree of the repository (a parent commit unpacked under the
git-ignored ``build/``) as well as this one; ``chip_smoke.py`` and
``profile_train.py``'s kernel groups are read from this file's repository. On the card, with its name and
power limit, it prints:

- K8 and X3 at every shape of ``WINO_SHAPES + X3_LEVELS + WINO_RAGGED``, ms
  per call (CUDA events, 20 calls after 3 warm-up): with U given where the
  tree's wrappers take it (``u=``), and the whole call, beside
  ``F.conv2d``'s;
- SD v1 serving at batch 1 (512², PLMS 50, guidance 7.5, bf16, seeded random
  weights) in turns: bf16, ``SD_TPU_CONV_IMPL=winograd`` twice, bf16, after
  one warm-up request of each: seconds per request and ms per UNet
  evaluation (sampling seconds over S+1); then ``PROFILED`` UNet
  evaluations at B=2 in each mode under one ``torch.profiler`` session:
  wall and device-busy ms per evaluation, the card's idle share and the
  device time by kernel group;

then one JSON line of all of it, last. Needs a card.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[2]
PROFILED = 3
PAUSE_S = 0.2


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def time_kernels(smoke) -> dict:
    from sd_tpu_torch.ops.cuda import winograd_conv3x3, winograd_conv3x3_split
    from sd_tpu_torch.ops.cuda.winograd_conv import weight_transform

    takes_u = "u" in inspect.signature(winograd_conv3x3).parameters
    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    shapes = [(b, c, hw, hw, k) for b, c, hw, k in smoke.WINO_SHAPES + smoke.X3_LEVELS]
    out = {}
    for b, c, h, w, k in shapes + list(smoke.WINO_RAGGED):
        x = randn(b, c, h, w).to(torch.bfloat16)
        wt = (randn(k, c, 3, 3) * (9 * c) ** -0.5).to(torch.bfloat16)
        u = weight_transform(wt).to(torch.bfloat16).contiguous()
        row = {"conv2d_ms": smoke.time_ms(lambda: F.conv2d(x, wt, padding=1))}
        for label, fn in (("K8", winograd_conv3x3), ("X3", winograd_conv3x3_split)):
            row[f"{label}_call_ms"] = smoke.time_ms(lambda: fn(x, wt))
            if takes_u:
                row[f"{label}_ms"] = smoke.time_ms(lambda: fn(x, wt, u=u))
        out["x".join(map(str, (b, c, h, w, k)))] = row
        print(f"[{b},{c},{h},{w}]->{k}: " + ", ".join(f"{key} {v:.4f}" for key, v in row.items()),
              flush=True)
    return out


def time_serving(smoke) -> dict:
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline

    pipe, _ = build_txt2img_pipeline(device="cuda", seed=0, watermark=False, int8="off",
                                     safety=False, fused_conv="auto", conv_impl="auto")

    def request(impl: str) -> dict:
        pipe.ldm.set_conv_modes("auto", impl)
        gen = torch.Generator(device="cuda").manual_seed(0)
        pipe([smoke.PROMPT], gen, height=512, width=512, steps=smoke.STEPS, guidance_scale=7.5)
        t = pipe.last_timings
        return {"mode": impl, "s": t["total_s"],
                "ms_per_unet_eval": t["sample_s"] * 1e3 / (smoke.STEPS + 1)}

    request("auto")
    request("winograd")
    turns = [request(impl) for impl in ("auto", "winograd", "winograd", "auto")]
    for turn in turns:
        print(json.dumps(turn), flush=True)
    split = profile_modes(pipe.ldm)
    print(json.dumps(split), flush=True)
    pipe.ldm.set_conv_modes("auto", "auto")
    del pipe
    smoke.free_memory()
    return {"requests_b1": turns, "unet_eval_split_b2": split}


def profile_modes(ldm, modes=("auto", "winograd")) -> dict:
    """``PROFILED`` UNet evaluations at B=2 for each conv mode, as
    ``bench_attention.profile_unet`` makes them, in one profiler session (a
    second session in one process once recorded no device events, and host
    time after a first one reads high): wall ms per evaluation (host clock
    after a sync, before the profiler starts), device-busy ms, the card's
    idle share and the device ms by kernel group, the kernels split at the
    pause after each mode."""
    from sd_tpu_torch.scripts.profile_train import _busy_us, group_of

    g = torch.Generator(device="cuda").manual_seed(0)
    args = (torch.randn((2, 4, 64, 64), generator=g, device="cuda").to(torch.bfloat16),
            torch.full((2,), 500, device="cuda", dtype=torch.long),
            torch.randn((2, 77, 768), generator=g, device="cuda").to(torch.bfloat16))
    wall_ms = {}
    with torch.no_grad():
        for impl in modes:
            ldm.set_conv_modes("auto", impl)
            ldm.apply_model(*args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILED):
                ldm.apply_model(*args)
            torch.cuda.synchronize()
            wall_ms[impl] = (time.perf_counter() - t0) * 1e3 / PROFILED
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for impl in modes:
                ldm.set_conv_modes("auto", impl)
                for _ in range(PROFILED):
                    ldm.apply_model(*args)
                torch.cuda.synchronize()
                time.sleep(PAUSE_S)
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and getattr(e, "activity_type", None) != "gpu_user_annotation"),
                     key=lambda e: e.time_range.start)
    gaps = sorted(range(1, len(kernels)), key=lambda i: kernels[i].time_range.start
                  - kernels[i - 1].time_range.end)[len(kernels) - len(modes):]
    cuts = [0, *sorted(gaps), len(kernels)]
    out = {}
    for impl, lo, hi in zip(modes, cuts, cuts[1:]):
        part = kernels[lo:hi]
        busy = _busy_us([(e.time_range.start, e.time_range.end) for e in part]) / 1e3
        busy /= PROFILED
        groups = {}
        for e in part:
            key = group_of(e.name)
            groups[key] = groups.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / PROFILED
        out[impl] = {"wall_ms": wall_ms[impl], "busy_ms": busy,
                     "idle_share": 1 - busy / wall_ms[impl], "kernels": len(part) / PROFILED,
                     "group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_winograd: no CUDA device is available")
    import sd_tpu_torch

    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    # the profiler's kernel groups of this repository (they name K8 and X3),
    # whichever tree is timed
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
