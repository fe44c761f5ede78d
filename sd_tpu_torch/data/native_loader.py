"""The native C++ image loader (port of ``sd_tpu/data/native_loader.py``):
``ctypes`` bindings to ``native/dataloader.cpp``, host code that decodes
JPEG and PNG files, center-crops them to squares, resizes them (an area
average when shrinking, bilinear when growing), scales them to float32
[-1, 1] NHWC and, with a seed, flips each left to right with probability
1/2, in a pool of C++ threads with no Python in the loop.

The port builds the source itself with ``g++`` (libjpeg, libpng) into
``build/native/`` at the repository root (git-ignored, beside the
kernels), under a name keyed to a hash of the source, once per process and
at first use. :class:`NativeImageLoader` raises with the compiler's output
where the build fails; :func:`native_available` only reports.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

__all__ = ["NativeImageLoader", "native_available", "build_native_loader"]

_REPO = Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "native" / "dataloader.cpp"
_BUILD_DIR = _REPO / "build" / "native"
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
_LIBS = ["-ljpeg", "-lpng", "-lpthread"]


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(_FLAGS + _LIBS).encode() + _SOURCE.read_bytes())
    return _BUILD_DIR / f"libsdt_dataloader-{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build_native_loader() -> Path:
    """The loader's shared library, compiled where it is not yet built;
    raises ``RuntimeError`` with the compiler's output where that fails."""
    lib = _library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("native loader: no C++ compiler (g++ not on PATH, CXX unset)")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.tmp{os.getpid()}.so")
    cmd = [cxx, *_FLAGS, "-o", str(tmp), str(_SOURCE), *_LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native loader: the build failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _load_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_native_loader()))
    lib.sdt_create_pool.restype = ctypes.c_void_p
    lib.sdt_create_pool.argtypes = [ctypes.c_int]
    lib.sdt_destroy_pool.restype = None
    lib.sdt_destroy_pool.argtypes = [ctypes.c_void_p]
    lib.sdt_load_batch.restype = ctypes.c_int
    lib.sdt_load_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                                   ctypes.c_int, ctypes.c_int, ctypes.c_long,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.POINTER(ctypes.c_int)]
    return lib


def native_available() -> bool:
    """Whether the loader builds and loads here."""
    try:
        _load_lib()
    except (RuntimeError, OSError):
        return False
    return True


class NativeImageLoader:
    """A pool of ``num_threads`` C++ workers. ``load_batch(paths, size)``
    returns ``(batch [N, size, size, 3] float32 in [-1, 1], ok [N] bool)``;
    a file that fails to load leaves its slot zero and its ``ok`` False.
    ``flip_seed`` >= 0 flips each image with probability 1/2, the same
    images for the same seed; below 0 nothing is flipped."""

    def __init__(self, num_threads: int = 8):
        self._lib = _load_lib()
        self._pool = self._lib.sdt_create_pool(num_threads)

    def close(self) -> None:
        if getattr(self, "_pool", None):
            self._lib.sdt_destroy_pool(self._pool)
            self._pool = None

    def __del__(self):
        self.close()

    def load_batch(self, paths: Sequence[str], size: int,
                   flip_seed: int = -1) -> Tuple[np.ndarray, np.ndarray]:
        if self._pool is None:
            raise RuntimeError("NativeImageLoader: closed")
        n = len(paths)
        out = np.zeros((n, size, size, 3), np.float32)
        ok = np.zeros((n,), np.int32)
        c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        self._lib.sdt_load_batch(self._pool, c_paths, n, size, flip_seed,
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                 ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        return out, ok.astype(bool)
