"""Time the kernel library's build two ways, on a machine with ``nvcc``.

    python -m sd_tpu_torch.scripts.time_build

Builds every ``sd_tpu_torch/csrc/*.cu`` into a fresh temporary directory
four times, in the order serial, parallel, parallel, serial: serial is one
``nvcc -shared`` over all sources; parallel is what the port does at first
use (``_build.compile_library``: one ``nvcc`` per source, all started
together, then a link). Prints each time and the median of each way. Needs
no card.
"""

from __future__ import annotations

import statistics
import subprocess
import tempfile
import time
from pathlib import Path

from sd_tpu_torch.ops.cuda import _build


def build_serial(lib: Path) -> None:
    cu, _ = _build._sources()
    cmd = [_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(lib), *map(str, cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")


def main() -> None:
    ways = {"serial": build_serial, "parallel": _build.compile_library}
    times = {way: [] for way in ways}
    for i, way in enumerate(["serial", "parallel", "parallel", "serial"]):
        with tempfile.TemporaryDirectory(prefix="sd_tpu_build_") as tmp:
            t0 = time.perf_counter()
            ways[way](Path(tmp) / f"lib{i}.so")
            times[way].append(time.perf_counter() - t0)
        print(f"[time_build] {way}: {times[way][-1]:.2f} s", flush=True)
    n_sources = len(_build._sources()[0])
    print(f"[time_build] {n_sources} sources: serial median "
          f"{statistics.median(times['serial']):.2f} s, parallel median "
          f"{statistics.median(times['parallel']):.2f} s")


if __name__ == "__main__":
    main()
