"""Kernel C: one pyramid level of sparse LK with the next-image footprint
staged in shared memory.

``lk_level_band`` launches ``csrc/lk_band.cu`` for a CUDA tensor and takes
the plain version ``lk_level_plain`` (``kernels/lk.py``) for a CPU tensor;
it never falls back from one to the other.  It replaces the JAX package's
Pallas kernel ``_lk_level_kernel`` with band fetch
(``meshflow_tpu/kernels/_lk_pallas_band.py:89``).  It computes the function
kernel A (``lk_cuda.lk_level``) computes, on the same PAD=28 REFLECT_101
planes: the JAX band kernel's aligned zero slack is a Mosaic constraint
and is not carried over.  ``patch`` is the side of the staged patch, the
JAX kernel's ``pn``: ``PN_TOP`` at a tracker's top level, where large
motions live, ``PN_LOWER`` below.  ``lk_level_band.launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from meshflow_tpu_torch.kernels import _build, _launch
from meshflow_tpu_torch.kernels.lk import lk_level_plain
from meshflow_tpu_torch.kernels.lk_cuda import launch_level

PN_TOP = 72
PN_LOWER = 40

__all__ = ["PN_TOP", "PN_LOWER", "lk_level_band", "occupancy"]


def lk_level_band(
    prev_planes: torch.Tensor,
    next_planes: torch.Tensor,
    pts: torch.Tensor,
    guess: torch.Tensor,
    valid: torch.Tensor,
    status_in: torch.Tensor,
    rows: int,
    cols: int,
    shifted: bool = True,
    max_iters: int = 30,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-4,
    is_level0: bool = False,
    patch: int = PN_LOWER,
):
    """One LK pyramid level for all (pair, tile, feature) slots; the
    arguments and results of ``lk_level_plain``, plus the patch side."""
    args = (prev_planes, next_planes, pts, guess, valid, status_in)
    if all(a.device.type == "cpu" for a in args):
        return lk_level_plain(
            *args, rows, cols, shifted, max_iters, eps, min_eig_threshold,
            is_level0,
        )
    if patch < 22:
        raise ValueError(f"lk_level_band: patch {patch} < the 22-texel footprint")
    out = launch_level(
        "meshflow_lk_band", args, rows, cols, shifted, max_iters, eps,
        min_eig_threshold, is_level0, int(patch),
    )
    _launch.count(lk_level_band)
    return out


lk_level_band.launches = 0


def occupancy(channels: int, patch: int, hpad: int, wpad: int):
    """Kernel C's launch shape on the current card for a level geometry:
    resident warps per SM, shared bytes per block, warps per block,
    registers per thread."""
    out = [ctypes.c_int() for _ in range(4)]
    _build.check(
        _build.library().meshflow_lk_band_occupancy(
            channels, patch, hpad, wpad, *map(ctypes.byref, out)
        ),
        "lk_band occupancy",
    )
    return tuple(v.value for v in out)
