"""Time K7 (the fused GroupNorm-apply + SiLU + conv3x3) and K6 (the W8A8
dense projection), and one UNet evaluation in the fused and the int8
modes, for one tree of the repository.

    PYTHONPATH=<tree> python3 sd_tpu_torch/scripts/bench_fused_int8dense.py [label]

``sd_tpu_torch`` is imported from ``PYTHONPATH``, so the same script times
another tree of the repository (a parent commit unpacked under the
git-ignored ``build/``) as well as this one; the shapes, ``time_ms`` and the
yardsticks are read from this file's repository's ``chip_smoke.py``, and the
profiler's kernel groups from its ``profile_train.py``. Run it for the
parent, this tree, this tree and the parent, in one call. On the card, with
its name and power limit, it prints (ms per call: CUDA events, 20 calls
after 3 warm-up):

- K7 at every shape of ``FUSED_SHAPES`` and at the UNet's shapes at batch 8
  (B=16), with the weight repacked beforehand where the tree's wrapper takes
  it (as the resnet blocks call it), beside the unfused site (GroupNorm32,
  SiLU, cuDNN's conv, then the skip or the next GroupNorm's statistics) and
  cuDNN's conv alone on h;
- K6 at every shape of ``INT8_DENSE_SHAPES``, beside bf16 ``F.linear`` and
  ``torch._int_mm`` on the same codes (the library's int8 product without
  the quantization or the epilogue);
- under one ``torch.profiler`` session, ``PROFILED`` calls of K7 and the
  unfused site, and of K6 and ``F.linear``, at each of those shapes (the
  device ms per call: the kernel's own launches, and all of the
  yardstick's, which the host's call overhead does not blur), then
  ``PROFILED`` UNet evaluations at B=2 with ``SD_TPU_FUSED_CONV``'s
  ``force`` and off, and at B=16 in the int8 mode's ``all``, with every
  bucket (``proj``, K6's, is not in ``all``) and off: wall and device-busy
  ms per evaluation, the idle share and the device ms by kernel group
  (K7's, K6's and K4's apart);

then one JSON line of all of it, last. Needs a card.
"""

from __future__ import annotations

import importlib
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
# the int8 mode with every bucket, K6's proj among them ("all" has no proj)
EVERY = "conv,ff,attn,attn_pv,proj"


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@torch.no_grad()
def time_fused(smoke):
    """K7 per shape, as the resnet blocks call it when serving (no autograd);
    returns the rows and the profiler's (label, call, kernel names) segments."""
    from sd_tpu_torch.ops.cuda import fused_conv3x3
    from sd_tpu_torch.ops.norms import GroupNorm32, group_stats

    fc = importlib.import_module("sd_tpu_torch.ops.cuda.fused_conv")
    takes_wk = "wk" in inspect.signature(fused_conv3x3).parameters
    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    shapes = list(smoke.FUSED_SHAPES) + [(16,) + s[1:] for s in smoke.FUSED_SHAPES if s[0] == 2]
    rows, segments = {}, []
    for b, c, hw, n, launch in shapes:
        second = launch == "second"
        x = randn(b, c, hw, hw).to(torch.bfloat16)
        w = (randn(n, c, 3, 3) * (9 * c) ** -0.5).to(torch.bfloat16)
        gn = GroupNorm32(c).to(x.device, torch.bfloat16)
        a, d = fc.fold_gn_affine(*group_stats(x, 32), gn.weight.float(), gn.bias.float(), gn.eps)
        bias = 0.1 * randn(n)
        skip = randn(b, n, hw, hw).to(torch.bfloat16)
        kw = dict(a=a, d=d, bias=bias, skip=skip) if second else dict(a=a, d=d,
                                                                      emit_moments=True)
        if takes_wk:
            kw["wk"] = fc.repack_weight(w)
        bf16_b = bias.to(torch.bfloat16)
        h = F.silu(gn(x))

        def unfused(x=x, w=w, gn=gn, b=bf16_b, skip=skip, second=second):
            y = F.conv2d(F.silu(gn(x)), w, b, padding=1)
            return y + skip if second else group_stats(y, 32)

        row = {"K7_ms": smoke.time_ms(lambda: fused_conv3x3(x, w, **kw)),
               "unfused_ms": smoke.time_ms(unfused),
               "conv_ms": smoke.time_ms(lambda: F.conv2d(h, w, bf16_b, padding=1))}
        label = "x".join(map(str, (b, c, hw, hw, n))) + f" {launch}"
        rows[label] = row
        segments += [(f"K7 {label}", lambda x=x, w=w, kw=kw: fused_conv3x3(x, w, **kw),
                       ("fused_conv",)), (f"unfused {label}", unfused, None)]
        print(f"[K7] {(b, c, hw, hw, n, launch)}: "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items()), flush=True)
        del h
        smoke.free_memory()
    return rows, segments


def time_dense(smoke):
    """K6 per shape; returns the rows and the profiler's segments (K6's
    first design is an instance of K4's int8_gemm_kernel)."""
    from sd_tpu_torch.ops.cuda import int8_dense
    from sd_tpu_torch.ops.cuda.geglu_ff import quantize_cols
    from sd_tpu_torch.ops.quant import quantize_rows

    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    rows, segments = {}, []
    for m, c, f in smoke.INT8_DENSE_SHAPES:
        x = randn(m, c).to(torch.bfloat16)
        w = (randn(f, c) * c**-0.5).to(torch.bfloat16)
        b = 0.1 * randn(f)
        wq, sw = quantize_cols(w)
        xq = quantize_rows(x)[0]
        row = {"K6_ms": smoke.time_ms(lambda: int8_dense(x, w, b, prequant=(wq, sw))),
               "linear_ms": smoke.time_ms(lambda: F.linear(x, w, b.to(torch.bfloat16))),
               "int_mm_ms": smoke.time_ms(lambda: torch._int_mm(xq, wq.t()))}
        label = "x".join(map(str, (m, c, f)))
        rows[label] = row
        segments += [(f"K6 {label}",
                       lambda x=x, w=w, b=b, q=(wq, sw): int8_dense(x, w, b, prequant=q),
                       ("int8_dense_kernel", "int8_gemm_kernel")),
                     (f"F.linear {label}", lambda x=x, w=w, b=b.to(torch.bfloat16): F.linear(x, w, b),
                      None)]
        print(f"[K6] {(m, c, f)}: " + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
              flush=True)
        smoke.free_memory()
    return rows, segments


def profile_modes(kernel_segments) -> dict:
    """One profiler session (a second session in one process once recorded
    no device events) over segments split at a pause after each: for each
    (label, call, kernel names) of ``kernel_segments``, ``PROFILED`` calls,
    the device ms per call of the kernels so named (of all, for None); then
    for each (label,
    batch, fused mode, int8 mode), ``PROFILED`` UNet evaluations: the wall
    ms per evaluation (host clock after a sync, before the profiler starts),
    device-busy ms, the idle share and the device ms by kernel group."""
    from sd_tpu_torch.pipelines.build import build_txt2img_pipeline
    from sd_tpu_torch.scripts.profile_train import _busy_us, group_of

    pipe, _ = build_txt2img_pipeline(device="cuda", seed=0, watermark=False, int8="all",
                                     safety=False, fused_conv="auto", conv_impl="auto")
    ldm = pipe.ldm
    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b):
        return (torch.randn((b, 4, 64, 64), generator=g, device="cuda").to(torch.bfloat16),
                torch.full((b,), 500, device="cuda", dtype=torch.long),
                torch.randn((b, 77, 768), generator=g, device="cuda").to(torch.bfloat16))

    segments = [("fused B=2", 2, "force", "off"), ("bf16 B=2", 2, "off", "off"),
                ("int8 all B=16", 16, "off", "all"), ("int8 every bucket B=16", 16, "off", EVERY),
                ("bf16 B=16", 16, "off", "off")]
    args = {b: inputs(b) for b in (2, 16)}

    def unet(b, fused, int8):
        ldm.set_conv_modes(fused, "auto")
        ldm.set_int8_mode(int8)
        return lambda: ldm.apply_model(*args[b])

    wall_ms = {}
    with torch.no_grad():
        for label, *mode in segments:
            run = unet(*mode)
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
            for label, *mode in segments:
                run = unet(*mode)
                for _ in range(PROFILED):
                    run()
                torch.cuda.synchronize()
                time.sleep(PAUSE_S)
    kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and getattr(e, "activity_type", None) != "gpu_user_annotation"),
                     key=lambda e: e.time_range.start)
    parts = len(kernel_segments) + len(segments)
    gaps = sorted(range(1, len(kernels)), key=lambda i: kernels[i].time_range.start
                  - kernels[i - 1].time_range.end)[len(kernels) - parts:]
    cuts = [0, *sorted(gaps), len(kernels)]
    out = {"kernels": {}}
    for (label, _, names), lo, hi in zip(kernel_segments, cuts, cuts[1:]):
        ms = sum(e.time_range.elapsed_us() for e in kernels[lo:hi]
                 if names is None or any(k in e.name for k in names)) / 1e3 / PROFILED
        out["kernels"][label] = ms
        print(f"[profile] {label}: {ms:.4f} device ms per call", flush=True)
    for (label, *_), lo, hi in zip(segments, cuts[len(kernel_segments):],
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
    del pipe, ldm
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_fused_int8dense: no CUDA device is available")
    import sd_tpu_torch

    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    # the profiler's kernel groups of this repository (they name K4's, K6's
    # and K7's kernels of both designs), whichever tree is timed
    sys.modules["sd_tpu_torch.scripts.profile_train"] = _load(
        "profile_train", ROOT / "sd_tpu_torch" / "scripts" / "profile_train.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"label": sys.argv[1] if len(sys.argv) > 1 else "",
              "package": str(Path(sd_tpu_torch.__file__).parent), "card": smi}
    print(smi, flush=True)
    result["K7"], k7_segments = time_fused(smoke)
    result["K6"], k6_segments = time_dense(smoke)
    smoke.free_memory()
    result["profile"] = profile_modes(k7_segments + k6_segments)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
