"""Time X2 (the fused transformer-block tail) by launch, beside the unfused
block and K2 alone, for one tree of the repository.

    PYTHONPATH=<tree> python3 sd_tpu_torch/scripts/bench_tail.py [label]

``sd_tpu_torch`` is imported from ``PYTHONPATH``, so the same script times
another tree of the repository (a parent commit unpacked under the
git-ignored ``build/``) as well as this one; ``BLOCK_SITES``, ``time_ms``
and the profiler's run are this repository's (``chip_smoke.py``,
``bench_int8ff_block.profile``). Run it for the parent, this tree, this
tree and the parent, in one call. On the card, with its name and power
limit, it prints, per site of ``BLOCK_SITES`` (B=16, 8 heads, 77 keys of
128, inner 4C, the experiment's inputs):

- X2, the unfused block (``tail_unfused``: LayerNormFp32, to_q, plain-op
  cross-attention, to_out, LayerNormFp32 and FeedForward through K2) and
  K2 alone on [B N, C] with inner 4C, in ms per call (CUDA events, 20 calls
  after 3 warm-up);
- under one ``torch.profiler`` run, the device ms per call of X2's
  launches by kernel name (the first design's launch A
  ``tail_attn_ff_kernel`` and B ``ff_out_kernel``; this design's LN2 + Q
  ``x1_qkv_kernel``, attention + out-projection ``x1_attn_kernel`` with
  ``ln_rows_kernel``, and the feed-forward's ``geglu_gemm_kernel`` and
  ``geglu_splitk_reduce``), of the unfused block and of K2 alone;
- the block experiment's ``tail`` at its default (N = 4096, C = 320): ms per
  chained step, fused and unfused;

then one JSON line of all of it, last. Needs a card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
# X2's launches in either design, by kernel name
X2_LAUNCHES = {"A tail_attn_ff": ("tail_attn_ff_kernel",), "B ff_out": ("ff_out_kernel",),
               "LN2+Q": ("x1_qkv_kernel",), "attention+out": ("x1_attn_kernel", "ln_rows_kernel"),
               "FF": ("geglu_gemm_kernel", "geglu_splitk_reduce")}
K2_NAMES = ("geglu_gemm_kernel", "geglu_splitk_reduce")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@torch.no_grad()
def time_sites(smoke):
    """X2, the unfused block and K2 alone per site; returns the rows and the
    profiler's (label, call, {part: kernel names}) segments."""
    from sd_tpu_torch.ops.cuda import geglu_ff, tail_fused
    from sd_tpu_torch.scripts import exp_block_kernel as exp

    g = torch.Generator(device="cuda").manual_seed(0)
    rows, segments = {}, []
    for n, c in smoke.BLOCK_SITES:
        x, args = exp.tail_inputs(n, c, "cuda", seed=n + 1)
        weights = {k: v for k, v in args.items() if k not in ("kc", "vc", "kv_len")}
        mods = exp.tail_modules(**weights, dtype=x.dtype)
        m, inner = exp.B * n, 4 * c
        xf = torch.randn((m, c), generator=g, device="cuda").to(torch.bfloat16)
        w1 = (torch.randn((2 * inner, c), generator=g, device="cuda") * c**-0.5).to(torch.bfloat16)
        w2 = (torch.randn((c, inner), generator=g, device="cuda") * inner**-0.5).to(torch.bfloat16)
        b1, b2 = torch.zeros(2 * inner, device="cuda"), torch.zeros(c, device="cuda")
        x2 = lambda x=x, args=args: tail_fused(x, **args)
        unfused = lambda x=x, args=args, mods=mods: exp.tail_unfused(
            x, args["kc"], args["vc"], args["kv_len"], *mods)
        k2 = lambda xf=xf, w1=w1, b1=b1, w2=w2, b2=b2: geglu_ff(xf, w1, b1, w2, b2)
        label = "x".join(map(str, (exp.B, n, c)))
        rows[label] = {"X2_ms": smoke.time_ms(x2), "unfused_ms": smoke.time_ms(unfused),
                       "K2_ms": smoke.time_ms(k2)}
        segments += [(f"X2 {label}", x2, X2_LAUNCHES), (f"unfused {label}", unfused, {"all": None}),
                     (f"K2 {label}", k2, {"K2": K2_NAMES})]
        print(f"[X2] {(exp.B, n, c)}: " + ", ".join(f"{k} {v:.4f}" for k, v in rows[label].items()),
              flush=True)
    return rows, segments


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench_tail: no CUDA device is available")
    import sd_tpu_torch
    from sd_tpu_torch.scripts import exp_block_kernel as exp

    smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    sys.modules["chip_smoke"] = smoke
    sys.modules["sd_tpu_torch.scripts.profile_train"] = _load(
        "profile_train", ROOT / "sd_tpu_torch" / "scripts" / "profile_train.py")
    bench = _load("bench_int8ff_block", ROOT / "sd_tpu_torch" / "scripts" / "bench_int8ff_block.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"label": sys.argv[1] if len(sys.argv) > 1 else "",
              "package": str(Path(sd_tpu_torch.__file__).parent), "card": smi}
    print(smi, flush=True)
    result["sites"], segments = time_sites(smoke)
    smoke.free_memory()
    result["profile"] = bench.profile(segments, unet=False)
    smoke.free_memory()
    step = exp.run("tail", 4096, 320)
    result["experiment_tail"] = {k: step[k] for k in ("tail_fused", "tail_unfused")}
    print(f"[experiment] tail 4096 320: {result['experiment_tail']}", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
