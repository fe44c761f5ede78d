"""Plant faults in copies of K1's, K3's, K5's, K8's, X3's, K2's, K7's, K6's,
K4's, X1's and X2's sources and show that ``chip_smoke.py``'s checks fail on
each, at every shape they cover.

    python -m sd_tpu_torch.scripts.flash_faults [K1|K3|K5|K8|X3|K2|K7|K6|K4|X1|X2 ...]   (from the repository root)

For each fault in :data:`FAULTS` (those of the kernels named, or all) the
package is copied into ``build/flash_faults/<name>/`` (git-ignored), the
fault's replacements are made in the copy's ``csrc`` (each must match its
expected count, so a fault that no longer applies fails loudly), and a
child process with that copy first on ``sys.path`` builds its kernels and
runs the smoke's checks: ``flash_case`` (K1 faults) or ``flash_bwd_case``
(K3 faults) at every N=4096 shape of ``FLASH_SHAPES`` or ``BWD_SHAPES``
and, for K3, at both ``VAE_BWD_SHAPES`` (its d = 512 plan; "K3 wide": at
those only), with plain and with sharp logits; ``winograd_case`` (K8 and X3 faults, one
source) at every UNet shape (B=2) of ``WINO_SHAPES``, K8 and X3 both;
``int8_flash_case`` (K5 faults) at every shape of ``INT8_FLASH_SHAPES``
whose mode the fault touches ("K5": both modes, "K5 qkpv": that mode
only); ``geglu_case`` (K2 faults) at every shape of ``FF_SHAPES``;
``fused_conv_case`` (K7 faults) at every shape of ``FUSED_SHAPES``;
``int8_dense_case`` (K6 faults) at every shape of ``INT8_DENSE_SHAPES``;
``int8_ff_case`` (K4 faults) at every shape of ``INT8_FF_SHAPES``;
``check_x1_site`` (X1 faults) or ``check_x2_site`` (X2 faults) at every
site of ``BLOCK_SITES``. A run
"fails" where a check raises ``CheckFailed``; its margin is the error over
the check's bound. The script prints one JSON line of every margin, last,
and exits 1 unless every fault failed at every shape. Needs a card.

    python -m sd_tpu_torch.scripts.flash_faults --first-stage [K1|K3 ...]

reads the smoke's end-to-end first-stage comparison instead (the kl-f8
VAE-GAN's first two steps at full width with K1 and K3 against the plain
attention: ``first_stage_steps`` and ``first_stage_gaps``), on the sound
sources and under each K1 and K3 fault (those of the kernels named, or
all). It prints every gap against its bound, and exits 1 only where the
sound sources exceed a bound: the readings set the bounds, and a fault the
comparison cannot see is reported, not refused.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# name: (K1, K3, K3 wide, K5, K5 qkpv, K8, X3, K2, K7, K6, K4, X1 or X2, [(source file,
# text, replacement, count)])
FAULTS = {
    "O not rescaled when the max moves": ("K1", [
        ("flash_mma.cuh", "    acc[j][0] *= c0;\n    acc[j][1] *= c0;\n    acc[j][2] *= c1;\n"
                          "    acc[j][3] *= c1;\n", "", 1)]),
    "the last key tile dropped": ("K1", [
        ("flash_attention.cu", "const int ntiles = (nk + BK - 1) / BK;",
         "const int ntiles = (nk + BK - 1) / BK - 1;", 3)]),
    "lse without the max": ("K1", [
        ("flash_mma.cuh", "return m + log2f(l);", "return log2f(l);", 1)]),
    "dV without p_lo's rounding": ("K3", [
        ("flash_attention_bwd.cu", "sdt::pack_bf16(p[0], p[1])", "__float_as_uint(p[0])", 2),
        ("flash_attention_bwd.cu", "sdt::pack_bf16(p[2], p[3])", "__float_as_uint(p[2])", 1)]),
    "dS without delta": ("K3", [
        ("flash_attention_bwd.cu", "return p * (dp - delta) * scale;", "return p * dp * scale;",
         1)]),
    "the wide plan's last streamed tile dropped": ("K3 wide", [
        ("flash_attention_bwd.cu", "const int ntiles = (n_str + BT - 1) / BT;",
         "const int ntiles = (n_str + BT - 1) / BT - 1;", 1)]),
    "the last channel step dropped": ("K8", [
        ("winograd_conv.cu", "const int nsteps = (C + CS - 1) / CS;",
         "const int nsteps = (C + CS - 1) / CS - 1;", 1)]),
    "one sign of the z1 fold flipped": ("K8", [
        ("winograd_conv.cu", "m[1][j] - m[2][j] - m[3][j]", "m[1][j] - m[2][j] + m[3][j]", 1)]),
    "X3's top halo row read from row 0": ("X3", [
        ("winograd_conv.cu", "const int yy = 2 * r0 - 1 + pr;",
         "const int yy = max(2 * r0 - 1 + pr, 0);", 1)]),
    "the key scale sk dropped from the logits": ("K5", [
        ("flash_attention_int8.cu",
         "const float2 kc = *reinterpret_cast<const float2*>(sks + j * 8 + 2 * tq);",
         "const float2 kc = make_float2(1.f, 1.f);", 1),
        ("flash_attention_int8.cu", "const float2 kc = *reinterpret_cast<const float2*>(\n"
         "        reinterpret_cast<const float*>(st + P::SK) + cg * 8 + 2 * tq);",
         "const float2 kc = make_float2(1.f, 1.f);", 1)]),
    "P's codes against the tile's max in place of the chunk's": ("K5 qkpv", [
        ("flash_attention_int8.cu", "const float pr0 = m0, pr1 = m1;",
         "const float pr0 = PV8 ? t0 : m0, pr1 = PV8 ? t1 : m1;", 1)]),
    "two keys swapped between P's packing and V's staging": ("K5 qkpv", [
        ("flash_attention_int8.cu", "const int slot = (kr / 32) * 32 + pv_slot(kr % 32);",
         "const int slot = (kr / 32) * 32 + pv_slot(kr % 32 < 2 ? 1 - kr % 32 : kr % 32);",
         1)]),
    "the gate's bias dropped": ("K2", [
        ("geglu_ff.cu",
         "      if (MODE == GEGLU) bg = *reinterpret_cast<const float2*>(bias + n + col);\n",
         "", 1)]),
    "the first GEMM's last k tile dropped": ("K2", [
        ("geglu_ff.cu", "  return min(ktiles, kt0 + tiles_per_split);",
         "  return min(ktiles, kt0 + tiles_per_split) - (MODE == GEGLU);", 1)]),
    "the prologue applied to the border taps": ("K7", [
        ("fused_conv.cu", "  return gy >= 0 && gy < H && gx >= 0 && gx < W;\n", "  return true;\n", 1)]),
    "the last channel step of each split dropped": ("K7", [
        ("fused_conv.cu", "const int nch = min(C / BC, ch0 + chunks_per_split) - ch0;",
         "const int nch = min(C / BC, ch0 + chunks_per_split) - ch0 - 1;", 1)]),
    "tap 5's column shift off by one": ("K7", [
        ("fused_conv.cu", "const int dy = tap / 3, dx = tap % 3;",
         "const int dy = tap / 3, dx = tap % 3 - (tap == 5);", 1)]),
    "one row's scale taken from its neighbour": ("K6", [
        ("int8_wgmma.cuh", "const float s_lo = scale[arow0 + rl],",
         "const float s_lo = scale[arow0 + rl + (rl == 0)],", 1)]),
    "the last k tile dropped": ("K6", [
        ("int8_wgmma.cuh", "const int ksteps = c / 32;",
         "const int ksteps = min(c / 32, (kblocks - 1) * (BK / 32));", 1)]),
    "the row max of h taken over one column tile only": ("K4", [
        ("int8_wgmma.cuh", "hmax[mt][hh] = fmaxf(hmax[mt][hh],",
         "hmax[mt][hh] = nt > 0 ? hmax[mt][hh] : fmaxf(hmax[mt][hh],", 1)]),
    "a row's scale of h taken from its neighbour": ("K4", [
        ("geglu_ff_int8.cu", "quant_scale(rowmax[m0 + qr])", "quant_scale(rowmax[m0 + (qr ^ 1)])",
         1)]),
    "the second GEMM's last k stage dropped": ("K4", [
        ("geglu_ff_int8.cu", "const int kb1 = min(kblocks, kb0 + kb_per_split);",
         "const int kb1 = min(kblocks, kb0 + kb_per_split) - (kb0 + kb_per_split >= kblocks);",
         1)]),
    "X1's last key tile dropped": ("X1", [
        ("fused_block.cuh", "const int ntiles = (nkeys + BK - 1) / BK;",
         "const int ntiles = (nkeys + BK - 1) / BK - 1;", 1)]),
    "a head's output written into another head's columns": ("X1", [
        ("fused_block.cuh", "const int hcol = h * d;", "const int hcol = (h ^ 1) * d;", 1)]),
    "LayerNorm's variance without the mean squared": ("X1", [
        ("fused_block.cuh", "fmaxf(sumsq / c - mean * mean, 0.f)", "fmaxf(sumsq / c, 0.f)", 1)]),
    "X2's key mask widened to nk": ("X2", [
        ("tail_fused.cu", "  a.nkeys = kv_len;", "  a.nkeys = nk;", 1)]),
    "a head's logits against another head's K columns": ("X2", [
        ("fused_block.cuh", "kb + h * d", "kb + (h ^ 1) * d", 2)]),
    "X2's head output written into another head's columns": ("X2", [
        ("fused_block.cuh", "const int hcol = h * d;", "const int hcol = (h ^ 1) * d;", 1)]),
    "LN3's variance without the mean squared": ("X2", [
        ("fused_block.cuh", "fmaxf(sq / c - mu * mu, 0.f)", "fmaxf(sq / c, 0.f)", 1)]),
    "x in place of x1 in the residual epilogue": ("X2", [
        ("tail_fused.cu", "const bf16* resid = x1p;", "const bf16* resid = xp;", 1)]),
    "the second GEMM's last k stage dropped in X2": ("X2", [
        ("geglu_ff.cu", "  return min(ktiles, kt0 + tiles_per_split);",
         "  return min(ktiles, kt0 + tiles_per_split) -\n"
         "         (MODE != GEGLU && kt0 + tiles_per_split >= ktiles);", 1)]),
}


def plant(csrc: Path, edits) -> None:
    """Make a fault's replacements in the sources under ``csrc``."""
    for name, text, replacement, count in edits:
        path = csrc / name
        source = path.read_text()
        found = source.count(text)
        if found != count:
            raise RuntimeError(f"{name}: {text!r} found {found} times, expected {count}")
        path.write_text(source.replace(text, replacement))


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_checks(kernel: str) -> dict:
    """In the child: the smoke's K1 or K3 case at every N=4096 shape, plain
    and sharp, its Winograd case (K8 and X3) at every UNet shape, its K5
    case at every int8 attention shape of the fault's modes, its K2 case
    at every FF shape, its K7 case at every fused-conv launch, its K6 case
    at every int8 dense shape, its K4 case at every int8 FF shape or its X1
    or X2 check at every block site; returns {shape (sharp): margin, or None
    where it passed}."""
    import torch

    smoke = _smoke()
    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    margins = {}
    if kernel in ("X1", "X2"):
        check = smoke.check_x1_site if kernel == "X1" else smoke.check_x2_site
        for n, c in smoke.BLOCK_SITES:
            label = "x".join(map(str, (16, n, c)))
            try:
                check(n, c)
                margins[label] = None
            except smoke.CheckFailed as failed:
                margins[label] = failed.err / failed.limit
            smoke.free_memory()
        return margins
    if kernel in ("K7", "K6", "K4"):
        shapes, case = {"K7": (smoke.FUSED_SHAPES, smoke.fused_conv_case),
                        "K6": (smoke.INT8_DENSE_SHAPES, smoke.int8_dense_case),
                        "K4": (smoke.INT8_FF_SHAPES, smoke.int8_ff_case)}[kernel]
        for shape in shapes:
            label = "x".join(map(str, shape))
            try:
                case(randn, shape, timed=False)
                margins[label] = None
            except smoke.CheckFailed as failed:
                margins[label] = failed.err / failed.limit
            smoke.free_memory()
        return margins
    if kernel in ("K5", "K5 qkpv", "K2"):
        shapes = (smoke.FF_SHAPES if kernel == "K2" else
                  [s for s in smoke.INT8_FLASH_SHAPES if kernel == "K5" or s[4] == "qkpv"])
        case = smoke.geglu_case if kernel == "K2" else smoke.int8_flash_case
        for shape in shapes:
            label = "x".join(map(str, shape))
            try:
                case(randn, shape, timed=False)
                margins[label] = None
            except smoke.CheckFailed as failed:
                margins[label] = failed.err / failed.limit
            smoke.free_memory()
        return margins
    if kernel in ("K8", "X3"):
        for b, c, hw, k in (s for s in smoke.WINO_SHAPES if s[0] == 2):
            label = "x".join(map(str, (b, c, hw, hw, k)))
            try:
                smoke.winograd_case(randn, (b, c, hw, hw, k), timed=False)
                margins[label] = None
            except smoke.CheckFailed as failed:
                margins[label] = failed.err / failed.limit
        return margins
    if kernel == "K1":
        shapes = [s for s in smoke.FLASH_SHAPES if s[1] == 4096]
    else:  # K3's N=4096 shapes and its d = 512 plan's ("K3 wide": those only)
        shapes = smoke.VAE_BWD_SHAPES + ([] if kernel == "K3 wide" else
                                         [s for s in smoke.BWD_SHAPES if s[1] == 4096])
    case = smoke.flash_case if kernel == "K1" else smoke.flash_bwd_case
    for shape in shapes:
        for sharp in (False, True):
            label = "x".join(map(str, shape)) + ("/sharp" if sharp else "")
            try:
                case(randn, shape, sharp=sharp, timed=False)
                margins[label] = None
            except smoke.CheckFailed as failed:
                margins[label] = failed.err / failed.limit
            smoke.free_memory()
    return margins


def first_stage_child() -> dict:
    """In the child: the smoke's first-stage comparison, the kernels' two
    steps against the plain attention's; {what: [gap, bound]}."""
    import tempfile

    smoke = _smoke()
    with tempfile.TemporaryDirectory(prefix="kl_f8_faults_") as logdir:
        argv = smoke.first_stage_argv(logdir)
        got = smoke.first_stage_steps(argv, 2, plain=False)
        ref = smoke.first_stage_steps(argv, 2, plain=True)
    return {k: list(v) for k, v in smoke.first_stage_gaps(*got, *ref).items()}


def faulted_copy(name: str, edits) -> Path:
    """The package copied into ``build/flash_faults/<name>/`` with the
    fault's replacements made in its sources."""
    copy = ROOT / "build" / "flash_faults" / name.replace(" ", "_").replace("'", "")
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(ROOT / "sd_tpu_torch", copy / "sd_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    plant(copy / "sd_tpu_torch" / "csrc", edits)
    return copy


def run_child(name: str, tree: Path, args) -> dict:
    """This script's child run with ``tree`` first on ``sys.path``: its
    last line's JSON."""
    proc = subprocess.run([sys.executable, __file__, *args], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=str(tree)), cwd=tree)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: the check run failed ({proc.returncode}):\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def first_stage_readings(wanted) -> None:
    """The first-stage comparison on the sound sources, then under each
    K1 and K3 fault of the kernels in ``wanted``."""
    runs = [("sound", "", [])] + [(name, kernel, edits) for name, (kernel, edits)
                                  in FAULTS.items() if kernel.split()[0] in wanted]
    results = {}
    for name, kernel, edits in runs:
        tree = faulted_copy(name, edits) if edits else ROOT
        gaps = run_child(name, tree, ["--child-first-stage"])
        over = [k for k, (gap, bound) in gaps.items() if not gap <= bound]
        worst = max(gaps, key=lambda k: gaps[k][0] / gaps[k][1]
                    if gaps[k][0] == gaps[k][0] else float("inf"))
        results[name] = {"kernel": kernel, "gaps": gaps, "over": over}
        print(f"[first stage, {name}] " + ", ".join(f"{k} {g:.3e} ({b})"
                                                     for k, (g, b) in gaps.items())
              + f"; worst {worst} at {gaps[worst][0] / gaps[worst][1]:.3g} of its bound; "
              f"{'over its bound at ' + str(over) if over else 'within every bound'}",
              flush=True)
    print(json.dumps(results))
    if results["sound"]["over"]:
        raise SystemExit("flash_faults: the sound sources exceed a first-stage bound")


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--child":
        print(json.dumps(run_checks(" ".join(sys.argv[2:]))))
        return
    if sys.argv[1:] == ["--child-first-stage"]:
        print(json.dumps(first_stage_child()))
        return
    if sys.argv[1:2] == ["--first-stage"]:
        first_stage_readings(set(sys.argv[2:]) or {"K1", "K3"})
        return
    wanted = set(sys.argv[1:]) or {kernel.split()[0] for kernel, _ in FAULTS.values()}
    results, ok = {}, True
    for name, (kernel, edits) in FAULTS.items():
        if kernel.split()[0] not in wanted:
            continue
        margins = run_child(name, faulted_copy(name, edits), ["--child", *kernel.split()])
        # a shape fails where its plain or its sharp run fails
        by_shape = {}
        for label, margin in margins.items():
            by_shape.setdefault(label.split("/")[0], []).append(margin)
        missed = [shape for shape, runs in by_shape.items() if all(m is None for m in runs)]
        ok &= not missed
        results[name] = {"kernel": kernel, "margins": margins, "shapes_missed": missed}
        readings = ", ".join(f"{label} {'passed' if m is None else f'{m:.3g}'}"
                             for label, m in margins.items())
        print(f"[{kernel} fault] {name}: error over bound {readings}; "
              f"{'fails at every shape' if not missed else f'MISSED at {missed}'}", flush=True)
    print(json.dumps(results))
    if not ok:
        raise SystemExit("flash_faults: a planted fault passed the checks at some shape")


if __name__ == "__main__":
    main()
