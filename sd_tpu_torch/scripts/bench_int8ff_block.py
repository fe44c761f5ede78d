"""Time K4 (the W8A8 GEGLU feed-forward) and X1 (the fused self-attention
sub-block), one UNet evaluation in the int8 mode and serving at batch 8,
for one tree of the repository.

    PYTHONPATH=<tree> python3 sd_tpu_torch/scripts/bench_int8ff_block.py [label] [--kernels-only]

``sd_tpu_torch`` is imported from ``PYTHONPATH``, so the same script times
another tree of the repository (a parent commit unpacked under the
git-ignored ``build/``) as well as this one; the shapes, ``time_ms`` and the
inputs are read from this file's repository's ``chip_smoke.py``, and the
profiler's kernel groups from its ``profile_train.py``. Run it for the
parent, this tree, this tree and the parent, in one call. On the card, with
its name and power limit, it prints (ms per call: CUDA events, 20 calls
after 3 warm-up):

- K4 at every shape of ``INT8_FF_SHAPES`` beside bf16 K2 on the same x;
- X1 at every site of ``BLOCK_SITES`` (B=16, 8 heads, the experiment's
  inputs) beside the unfused block (``LayerNormFp32`` and ``CrossAttention``
  through K1, plus the residual);
- under one ``torch.profiler`` session, ``PROFILED`` calls of each of
  those (the device ms per call: K4's and K2's own launches; X1's by
  launch, A being LN + QKV and B attention + out-projection, in either
  tree's kernel names; all of the unfused block's), then ``PROFILED`` UNet
  evaluations at B=16 in the int8 mode's ``all`` and in bf16: wall and
  device-busy ms per evaluation, the idle share and the device ms by kernel
  group (K4's apart);
- SD v1 serving at batch 8 (512², PLMS 50, guidance 7.5, seeded random
  weights) in turns after one warm-up request of each: bf16, int8 ``all``
  twice, bf16: images/s and ms per UNet evaluation;

then one JSON line of all of it, last (``--kernels-only``: the kernels'
rows and profiles alone, without the UNet and the requests). Needs a card.
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
# kernel names of each part, in this design and in the first ones (K4's WMMA GEMMs, X1's
# WMMA launches), so that an older tree is timed alike
K4_NAMES = ("k4_out_kernel", "int8_dense_kernel", "int8_gemm_kernel", "quant_rows_kernel",
            "Memset", "FillFunctor")
K2_NAMES = ("geglu_gemm_kernel", "geglu_splitk_reduce")
X1_LAUNCHES = {"A": ("x1_qkv_kernel", "ln_qkv_kernel"), "B": ("x1_attn_kernel", "attn_out_kernel")}


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@torch.no_grad()
def time_k4(smoke):
    """K4 and bf16 K2 per shape; returns the rows and the profiler's
    (label, call, {part: kernel names}) segments."""
    from sd_tpu_torch.ops.cuda import geglu_ff, geglu_ff_int8
    from sd_tpu_torch.ops.cuda.geglu_ff import quantize_ff_weights

    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    rows, segments = {}, []
    for m, c, inner in smoke.INT8_FF_SHAPES:
        x = randn(m, c).to(torch.bfloat16)
        w1 = (randn(2 * inner, c) * c**-0.5).to(torch.bfloat16)
        w2 = (randn(c, inner) * inner**-0.5).to(torch.bfloat16)
        b1, b2 = 0.1 * randn(2 * inner), 0.1 * randn(c)
        qw = quantize_ff_weights(w1, w2, torch.bfloat16)
        k4 = lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2, qw=qw: geglu_ff_int8(x, w1, b1, w2, b2, qw)
        k2 = lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: geglu_ff(x, w1, b1, w2, b2)
        label = "x".join(map(str, (m, c, inner)))
        rows[label] = {"K4_ms": smoke.time_ms(k4), "K2_ms": smoke.time_ms(k2)}
        segments += [(f"K4 {label}", k4, {"K4": K4_NAMES}), (f"K2 {label}", k2, {"K2": K2_NAMES})]
        print(f"[K4] {(m, c, inner)}: " + ", ".join(f"{k} {v:.4f}" for k, v in rows[label].items()),
              flush=True)
    return rows, segments


@torch.no_grad()
def time_x1(smoke):
    """X1 and the unfused block per site; returns the rows and the
    profiler's segments."""
    from sd_tpu_torch.ops.cuda import fused_block
    from sd_tpu_torch.scripts import exp_block_kernel as exp

    rows, segments = {}, []
    for n, c in smoke.BLOCK_SITES:
        x, args = exp.block_inputs(n, c, "cuda", seed=n)
        mods = exp.self_attention_modules(**args, dtype=x.dtype)
        x1 = lambda x=x, args=args: fused_block(x, **args)
        unfused = lambda x=x, mods=mods: exp.unfused_block(x, *mods)
        label = "x".join(map(str, (exp.B, n, c)))
        rows[label] = {"X1_ms": smoke.time_ms(x1), "unfused_ms": smoke.time_ms(unfused)}
        segments += [(f"X1 {label}", x1, X1_LAUNCHES), (f"unfused {label}", unfused, {"all": None})]
        print(f"[X1] {(exp.B, n, c)}: " + ", ".join(f"{k} {v:.4f}" for k, v in rows[label].items()),
              flush=True)
    return rows, segments


def profile(kernel_segments, unet: bool = True) -> dict:
    """One profiler session (a second session in one process once recorded
    no device events) over segments split at a pause after each: for each
    (label, call, parts) of ``kernel_segments``, ``PROFILED`` calls and the
    device ms per call of each part's kernels (all for None); then
    ``PROFILED`` UNet evaluations at B=16 in the int8 mode's ``all`` and in
    bf16: wall ms (host clock after a sync, before the profiler starts),
    device-busy ms, the idle share and the device ms by kernel group; then
    the batch-8 requests (without ``unet``: the kernels alone)."""
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.scripts.profile_train import _busy_us, group_of

    pipe = ldm = args = None
    modes = ()
    if unet:
        pipe, _ = build_txt2img_pipeline(device="cuda", seed=0, watermark=False, int8="all",
                                         safety=False, fused_conv="auto", conv_impl="auto")
        ldm = pipe.ldm
        g = torch.Generator(device="cuda").manual_seed(0)
        args = (torch.randn((16, 4, 64, 64), generator=g, device="cuda").to(torch.bfloat16),
                torch.full((16,), 500, device="cuda", dtype=torch.long),
                torch.randn((16, 77, 768), generator=g, device="cuda").to(torch.bfloat16))
        modes = ("int8 all B=16", "all"), ("bf16 B=16", "off")

    def unet_call(mode):
        ldm.set_int8_mode(mode)
        return lambda: ldm.apply_model(*args)

    wall_ms = {}
    with torch.no_grad():
        for label, mode in modes:
            run = unet_call(mode)
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILED):
                run()
            torch.cuda.synchronize()
            wall_ms[label] = (time.perf_counter() - t0) * 1e3 / PROFILED
        for _, call, _ in kernel_segments:
            call()
        torch.cuda.synchronize()
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            for _, call, _ in kernel_segments:
                for _ in range(PROFILED):
                    call()
                torch.cuda.synchronize()
                time.sleep(PAUSE_S)
            for _, mode in modes:
                run = unet_call(mode)
                for _ in range(PROFILED):
                    run()
                torch.cuda.synchronize()
                time.sleep(PAUSE_S)
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and getattr(e, "activity_type", None) != "gpu_user_annotation"),
                     key=lambda e: e.time_range.start)
    parts = len(kernel_segments) + len(modes)
    gaps = sorted(range(1, len(kernels)), key=lambda i: kernels[i].time_range.start
                  - kernels[i - 1].time_range.end)[len(kernels) - parts:]
    cuts = [0, *sorted(gaps), len(kernels)]
    out = {"kernels": {}}
    for (label, _, names), lo, hi in zip(kernel_segments, cuts, cuts[1:]):
        part = kernels[lo:hi]
        out["kernels"][label] = {
            key: sum(e.time_range.elapsed_us() for e in part
                     if keys is None or any(k in e.name for k in keys)) / 1e3 / PROFILED
            for key, keys in names.items()}
        print(f"[profile] {label}: {json.dumps(out['kernels'][label])} device ms per call",
              flush=True)
    for (label, _), lo, hi in zip(modes, cuts[len(kernel_segments):],
                                  cuts[len(kernel_segments) + 1:]):
        part = kernels[lo:hi]
        busy = _busy_us([(e.time_range.start, e.time_range.end) for e in part]) / 1e3 / PROFILED
        groups = {}
        for e in part:
            key = group_of(e.name)
            groups[key] = groups.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / PROFILED
        out[label] = {"wall_ms": wall_ms[label], "busy_ms": busy,
                      "idle_share": 1 - busy / wall_ms[label], "kernels": len(part) / PROFILED,
                      "group_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}
        print(f"[profile] {label}: {json.dumps(out[label])}", flush=True)
    if unet:
        out["requests_b8"] = serve(pipe)
    del pipe, ldm
    return out


def serve(pipe) -> list:
    """Batch-8 requests after one warm-up of each mode, in turns: bf16, int8
    ``all`` twice, bf16."""
    smoke = sys.modules["chip_smoke"]

    def request(mode: str) -> dict:
        pipe.ldm.set_int8_mode(mode)
        gen = torch.Generator(device="cuda").manual_seed(0)
        pipe([smoke.PROMPT] * smoke.BATCH8, gen, height=512, width=512, steps=smoke.STEPS,
             guidance_scale=7.5)
        t = pipe.last_timings
        return {"mode": mode, "s": t["total_s"], "images_per_s": smoke.BATCH8 / t["total_s"],
                "ms_per_unet_eval": t["sample_s"] * 1e3 / (smoke.STEPS + 1)}

    for mode in ("off", "all"):
        request(mode)
    turns = [request(mode) for mode in ("off", "all", "all", "off")]
    for turn in turns:
        print(json.dumps(turn), flush=True)
    return turns


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_int8ff_block: no CUDA device is available")
    import sd_tpu_torch

    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    sys.modules["chip_smoke"] = smoke
    # the profiler's kernel groups of this repository (they name K4's kernels
    # of both designs), whichever tree is timed
    sys.modules["sd_tpu_torch.scripts.profile_train"] = _load(
        "profile_train", ROOT / "sd_tpu_torch" / "scripts" / "profile_train.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    argv = [a for a in sys.argv[1:] if a != "--kernels-only"]
    result = {"label": argv[0] if argv else "",
              "package": str(Path(sd_tpu_torch.__file__).parent), "card": smi}
    print(smi, flush=True)
    result["K4"], k4_segments = time_k4(smoke)
    smoke.free_memory()
    result["X1"], x1_segments = time_x1(smoke)
    smoke.free_memory()
    result["profile"] = profile(k4_segments + x1_segments, "--kernels-only" not in sys.argv)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
