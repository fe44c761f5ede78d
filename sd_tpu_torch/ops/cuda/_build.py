"""Build and load the port's CUDA kernels.

Every ``sd_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and the objects are linked
into one shared library with a plain C interface, at first use, and loaded
with ``ctypes``. The library lands in ``build/sd_tpu_torch/`` at the repository
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
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, o, lse, batch, nq, nk, heads, d, scale, stream
    "sdt_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    # q, k, v, o, dout, lse, delta, dq, dk, dv, batch, nq, nk, heads, d, scale, stream
    "sdt_flash_attention_bwd": [_P] * 10 + [_I] * 5 + [ctypes.c_float, _P],
    # d, int[5] out: K1's launch plan
    "sdt_flash_plan": [_I, _P],
    # d, pass (1 dK/dV, 2 dQ), int[5] out: K3's launch plan
    "sdt_flash_bwd_plan": [_I, _I, _P],
    # x, w1, b1, w2, b2, h, ws, y, m, c, inner, c_out, stream
    "sdt_geglu_ff": [_P] * 8 + [_I] * 4 + [_P],
    # m, c, inner, c_out, int64 out: the fp32 elements of K2's k-split scratch
    "sdt_geglu_ff_workspace": [_I] * 4 + [_P],
    # m, c, inner, c_out, int[14] out: K2's plan, per GEMM
    "sdt_geglu_ff_plan": [_I] * 4 + [_P],
    # x, wq, sw, b, out, m, c, f, stream
    "sdt_int8_dense": [_P] * 5 + [_I] * 3 + [_P],
    # m, c, f, int[7] out: K6's plan
    "sdt_int8_dense_plan": [_I] * 3 + [_P],
    # x, w1q, s1, b1, w2q, s2, b2, h, scratch, y, m, c, inner, c_out, stream
    "sdt_geglu_ff_int8": [_P] * 10 + [_I] * 4 + [_P],
    # m, c, inner, c_out, int[17] out: K4's plans
    "sdt_geglu_ff_int8_plan": [_I] * 4 + [_P],
    # q, k, v, o, qq, sq, kq, sk, vq, sv, batch, n, heads, d, scale * log2(e),
    # pv8, stream
    "sdt_flash_attention_int8": [_P] * 10 + [_I] * 4 + [ctypes.c_float, _I, _P],
    # d -> the padded head dim of the int8 attention (0: not taken)
    "sdt_flash_int8_padded_dim": [_I],
    # batch, n, heads, d, pv8, int[5] out: K5's launch plan
    "sdt_flash_int8_plan": [_I] * 5 + [_P],
    # x, wk, a, d, bias, skip, y, m1, m2, ws, batch, c, h, w, n, stream
    "sdt_fused_conv3x3": [_P] * 10 + [_I] * 5 + [_P],
    # batch, c, h, w, n, int[8] out: K7's plan
    "sdt_fused_conv_plan": [_I] * 5 + [_P],
    # in (K8: the parity buffer; X3: x), u, y, batch, c, h, w, k, s1p, split,
    # stream
    "sdt_winograd_conv3x3": [_P] * 3 + [_I] * 7 + [_P],
    # split, batch, h, w, k, int[9] out: K8's or X3's launch plan
    "sdt_winograd_plan": [_I] * 5 + [_P],
    # x, gamma, beta, wqkv [3c, c], wo [c, c] (both out x in), bo, qkv, out,
    # batch, n, heads, d, stream
    "sdt_fused_block": [_P] * 8 + [_I] * 4 + [_P],
    # c, d -> the row tile of X1's attention launch (0: not taken)
    "sdt_fused_block_q": [_I, _I],
    # batch, n, c, d, int[17] out: X1's plans
    "sdt_fused_block_plan": [_I] * 4 + [_P],
    # x, g2, b2, wq, wo (both out x in), bo, kc, vc, g3, b3, w1 [2·inner, c],
    # b1, w2 [c, inner], bff, q, x1, xln, h, ws, out, batch, n, nk, kv_len,
    # heads, d, inner, stream
    "sdt_tail_fused": [_P] * 20 + [_I] * 7 + [_P],
    # batch, n, c, d, kv_len, inner, int[33] out: X2's plans
    "sdt_tail_fused_plan": [_I] * 6 + [_P],
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


def compile_library(lib: Path) -> str:
    """Compile every source into the shared library ``lib``, one ``nvcc`` per
    source in parallel, then link; returns nvcc's output."""
    cu, _ = _sources()
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.tmp{os.getpid()}"
    objects = [lib.parent / f"{tag}.{src.stem}.o" for src in cu]
    cmds = [[nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(cu, objects)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outputs = [proc.communicate() for proc in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{out}\n{err}")
    tmp = lib.with_name(f"{tag}.so")
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objects)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    return "".join(out + err for out, err in outputs) + proc.stdout + proc.stderr


@functools.cache
def build_info() -> dict:
    """Build the library unless it exists; return its path, the build
    seconds (0.0 when it was already built) and nvcc's resource report."""
    lib = _library_path()
    log = lib.with_suffix(".log")
    if lib.is_file():
        return {"path": str(lib), "seconds": 0.0,
                "log": log.read_text() if log.is_file() else ""}
    t0 = time.perf_counter()
    text = compile_library(lib)
    seconds = time.perf_counter() - t0
    log.write_text(text)
    return {"path": str(lib), "seconds": seconds, "log": text}


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
