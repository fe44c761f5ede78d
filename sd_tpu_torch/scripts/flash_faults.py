"""Plant faults in copies of K1's and K3's sources and show that
``chip_smoke.py``'s checks fail on each, at every N=4096 shape.

    python -m sd_tpu_torch.scripts.flash_faults            (from the repository root)

For each fault in :data:`FAULTS` the package is copied into
``build/flash_faults/<name>/`` (git-ignored), the fault's replacements are
made in the copy's ``csrc`` (each must match its expected count, so a
fault that no longer applies fails loudly), and a child process with that
copy first on ``sys.path`` builds its kernels and runs the smoke's
``flash_case`` (K1 faults) or ``flash_bwd_case`` (K3 faults) at every N=4096
shape of ``FLASH_SHAPES`` or ``BWD_SHAPES``, with plain and with sharp
logits. A run "fails" where a check raises ``CheckFailed``; its margin is
the error over the check's bound. The script prints one JSON line of every
margin, last, and exits 1 unless every fault failed at every shape. Needs a
card.
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

# name: (K1 or K3, [(source file, text, replacement, count)])
FAULTS = {
    "O not rescaled when the max moves": ("K1", [
        ("flash_mma.cuh", "    acc[j][0] *= c0;\n    acc[j][1] *= c0;\n    acc[j][2] *= c1;\n"
                          "    acc[j][3] *= c1;\n", "", 1)]),
    "the last key tile dropped": ("K1", [
        ("flash_attention.cu", "const int ntiles = (nk + BK - 1) / BK;",
         "const int ntiles = (nk + BK - 1) / BK - 1;", 2)]),
    "lse without the max": ("K1", [
        ("flash_mma.cuh", "return m + log2f(l);", "return log2f(l);", 1)]),
    "dV without p_lo's rounding": ("K3", [
        ("flash_attention_bwd.cu", "sdt::pack_bf16(p[0], p[1])", "__float_as_uint(p[0])", 1),
        ("flash_attention_bwd.cu", "sdt::pack_bf16(p[2], p[3])", "__float_as_uint(p[2])", 1)]),
    "dS without delta": ("K3", [
        ("flash_attention_bwd.cu", "return p * (dp - delta) * scale;", "return p * dp * scale;",
         1)]),
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
    and sharp; returns {shape (sharp): margin, or None where it passed}."""
    import torch

    smoke = _smoke()
    shapes = smoke.FLASH_SHAPES if kernel == "K1" else smoke.BWD_SHAPES
    case = smoke.flash_case if kernel == "K1" else smoke.flash_bwd_case
    g = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device="cuda")
    margins = {}
    for shape in (s for s in shapes if s[1] == 4096):
        for sharp in (False, True):
            label = "x".join(map(str, shape)) + ("/sharp" if sharp else "")
            try:
                case(randn, shape, sharp=sharp, timed=False)
                margins[label] = None
            except smoke.CheckFailed as failed:
                margins[label] = failed.err / failed.limit
            smoke.free_memory()
    return margins


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        print(json.dumps(run_checks(sys.argv[2])))
        return
    results, ok = {}, True
    for name, (kernel, edits) in FAULTS.items():
        copy = ROOT / "build" / "flash_faults" / name.replace(" ", "_").replace("'", "")
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(ROOT / "sd_tpu_torch", copy / "sd_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        plant(copy / "sd_tpu_torch" / "csrc", edits)
        env = dict(os.environ, PYTHONPATH=str(copy))
        proc = subprocess.run([sys.executable, __file__, "--child", kernel], env=env,
                              capture_output=True, text=True, cwd=copy)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: the check run failed ({proc.returncode}):\n"
                               f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        margins = json.loads(proc.stdout.strip().splitlines()[-1])
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
