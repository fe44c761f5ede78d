"""Build and load the port's CUDA kernels.

Every ``sd_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, at first use, and loaded with
``ctypes``. The library lands in ``build/sd_tpu_torch/`` at the repository
root (git-ignored) under a name keyed to a hash of the sources and flags, so
an edited source is rebuilt and an unchanged one is loaded as it is. A
missing ``nvcc`` raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["kernels", "build_info", "check", "stream_of"]

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "sd_tpu_torch"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, batch, nq, nk, heads, d, scale, stream
    "sdt_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # x, w1, b1, w2, b2, h, y, m, c, inner, c_out, stream
    "sdt_geglu_ff": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the port's CUDA "
        "kernels are built from sd_tpu_torch/csrc at first use")


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _library_path() -> Path:
    cu, headers = _sources()
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in cu + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return _BUILD_DIR / f"libsd_tpu_kernels-{digest.hexdigest()[:16]}.so"


@functools.cache
def build_info() -> dict:
    """Build the library unless it exists; return its path, the build
    seconds (0.0 when it was already built) and nvcc's resource report."""
    lib = _library_path()
    log = lib.with_suffix(".log")
    if lib.is_file():
        return {"path": str(lib), "seconds": 0.0,
                "log": log.read_text() if log.is_file() else ""}
    cu, _ = _sources()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return {"path": str(lib), "seconds": seconds, "log": proc.stdout + proc.stderr}


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(build_info()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.sdt_error_string.argtypes = [ctypes.c_int]
    lib.sdt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = kernels().sdt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(tensor) -> int:
    """The raw handle of PyTorch's current stream on the tensor's device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
