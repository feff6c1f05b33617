"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled with nvcc into one shared library with a plain C
interface and bound with ctypes; the library is built at the first kernel
launch of a process, into ``build/meshflow_tpu_torch/<hash>/`` at the root
of the checkout, keyed by a hash of the sources and flags, so a changed
source always rebuilds and an unchanged one is built once.  Each ``.cu``
file is compiled by its own nvcc process, all started together, and the
objects are then linked into the library.  A process loads the library
once, at its first launch, and keeps it: hashing the sources at every
launch cost each launch about a millisecond of host time.

Flags: ``sm_90a`` (Hopper); ``--fmad=false`` so no multiply-add is
contracted and every float operation rounds where the plain PyTorch
version rounds (the backward map's cell decisions must equal the plain
version's exactly); IEEE division and square root (``-prec-div=true
-prec-sqrt=true``, no fast math).
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

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "meshflow_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)
_LIB_NAME = "libmeshflow_kernels.so"


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

    Returns {"path", "seconds", "log"}: log is the compiler's output (ptxas
    registers and spills), kept beside the library; seconds is 0 when the
    library was already built.
    """
    out = library_path()
    log_path = out.with_name("build.log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(out), "seconds": 0.0, "log": log}
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    start = time.perf_counter()
    objects, procs = [], []
    tmp = out.with_name(f"{_LIB_NAME}.{tag}")
    try:
        for src in sorted(SRC_DIR.glob("*.cu")):
            obj = out.with_name(f"{src.stem}.{tag}.o")  # nvcc links by the .o suffix
            objects.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        log = ""
        for proc in procs:
            log += proc.communicate()[0]
        failed = [p.args[-1] for p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objects)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}")
        log += link.stdout
        log_path.write_text(log)
        os.replace(tmp, out)
    finally:
        for proc in procs:  # an exception above leaves no compiler running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in objects + [tmp]:
            path.unlink(missing_ok=True)
    seconds = time.perf_counter() - start
    return {"path": str(out), "seconds": seconds, "log": log}


@functools.cache
def library() -> ctypes.CDLL:
    """The process's kernel library (built and loaded at the first call),
    argtypes set."""
    lib = ctypes.CDLL(str(build()["path"]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.meshflow_lk_level.argtypes = [
        p, p, p, p, p, p, p, p,  # prev, next, pts, guess, valid, st, out, st_out
        p,  # work counter
        i, i, i, i,  # T, S, K, C
        i, i, i, i,  # hpad, wpad, rows, cols
        i, i, f, f, i,  # shift, max_iters, eps2, min_eig_thr, is_level0
        p,  # stream
    ]
    lib.meshflow_lk_level.restype = i
    lib.meshflow_lk_band.argtypes = lib.meshflow_lk_level.argtypes[:-1] + [
        i,  # pn: staged patch size
        p,  # stream
    ]
    lib.meshflow_lk_band.restype = i
    ip = ctypes.POINTER(ctypes.c_int)
    lib.meshflow_lk_level_occupancy.argtypes = [i, ip, ip, ip, ip]
    lib.meshflow_lk_level_occupancy.restype = i
    lib.meshflow_lk_band_occupancy.argtypes = [i, i, i, i, ip, ip, ip, ip]
    lib.meshflow_lk_band_occupancy.restype = i
    u = ctypes.c_uint
    lib.meshflow_bmap.argtypes = [
        p, p, p,  # stab_pos, unstab_grid, table workspace
        p, p, p,  # map_x, map_y, covered
        i, i, i, i, i,  # F, H, W, rows, cols
        u, i, i, u, i, i,  # rows' and cols' axis_divisor: magic, shift, bias
        p,  # stream
    ]
    lib.meshflow_bmap.restype = i
    lib.meshflow_bmap_occupancy.argtypes = [i, i, ip, ip, ip]
    lib.meshflow_bmap_occupancy.restype = i
    lib.meshflow_eig9.argtypes = [p, p, i, p]  # normal, out, batch, stream
    lib.meshflow_eig9.restype = i
    lib.meshflow_render_warp.argtypes = [
        p, p, p, p, p,  # frames, map_x, map_y, covered, out
        i, i, i, i,  # F, H, W, C
        f, f, f,  # the border colour
        p,  # stream
    ]
    lib.meshflow_render_warp.restype = i
    lib.meshflow_render_crop.argtypes = [
        p, p, i, p,  # frames, crop, crop is int64, out
        i, i, i, i,  # F, H, W, C
        p,  # stream
    ]
    lib.meshflow_render_crop.restype = i
    lib.meshflow_render_occupancy.argtypes = [i, i, ip, ip]  # crop, C, warps/SM, registers
    lib.meshflow_render_occupancy.restype = i
    # probes D-G (csrc/probe_*.cu); every entry point ends with the stream
    for name, args in {
        "meshflow_probe_dynslice_copy": [p, p, p, p, i, i, i, i],
        "meshflow_probe_dynslice_fine": [p, p, p, p, p, p, i, i, i, i],
        "meshflow_probe_onehot_rowsel": [p, p, p, p, i, i, i, i],
        "meshflow_probe_aligned_dynslice": [p, p, p, i, i],
        "meshflow_probe_select_rows": [p, p, p, i, i, i],
        "meshflow_probe_scalar_from_vmem": [p, p, p, i, i, i, i, i],
        "meshflow_probe_launch_floor": [i, i],
    }.items():
        getattr(lib, name).argtypes = args + [p]
        getattr(lib, name).restype = i
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
