"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled with nvcc into one shared library with a plain C
interface and bound with ctypes; the library is built at the first kernel
launch of a process, into ``build/meshflow_tpu_torch/<hash>/`` at the root
of the checkout, keyed by a hash of the sources and flags, so a changed
source always rebuilds and an unchanged one is built once.

Flags: ``sm_90a`` (Hopper); ``--fmad=false`` so no multiply-add is
contracted and every float operation rounds where the plain PyTorch
version rounds (the backward map's cell decisions must equal the plain
version's exactly); IEEE division and square root (``-prec-div=true
-prec-sqrt=true``, no fast math).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "meshflow_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
_LIB_NAME = "libmeshflow_kernels.so"

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of meshflow_tpu_torch are built "
        "with the CUDA toolkit at their first launch"
    )


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256()
    for src in sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / _LIB_NAME


def build() -> dict:
    """Compile the library if it is missing.

    Returns {"path", "seconds", "log"}: seconds is 0 and log empty when the
    library was already built.
    """
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(p) for p in sorted(SRC_DIR.glob("*.cu"))]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "log": proc.stdout + proc.stderr}


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed), argtypes set."""
    path = str(build()["path"])
    lib = _loaded.get(path)
    if lib is None:
        lib = ctypes.CDLL(path)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.meshflow_lk_level.argtypes = [
            p, p, p, p, p, p, p, p,  # prev, next, pts, guess, valid, st, out, st_out
            i, i, i, i,  # T, S, K, C
            i, i, i, i,  # hpad, wpad, rows, cols
            i, i, f, f, i,  # shift, max_iters, eps2, min_eig_thr, is_level0
            p,  # stream
        ]
        lib.meshflow_lk_level.restype = i
        lib.meshflow_bmap.argtypes = [
            p, p, p, p,  # table, map_x, map_y, covered
            i, i, i, i, i,  # F, H, W, rows, cols
            p,  # stream
        ]
        lib.meshflow_bmap.restype = i
        _loaded[path] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
