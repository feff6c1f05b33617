"""Kernel A: one pyramid level of sparse LK on the card, and the
coarse-to-fine tracker that drives kernel A or kernel C.

``lk_level`` launches ``csrc/lk_level.cu`` for a CUDA tensor and takes
the plain version ``lk_level_plain`` (``kernels/lk.py``) for a CPU
tensor; it never falls back from one to the other.  It replaces the JAX
package's Pallas kernel ``_lk_level_kernel``
(``meshflow_tpu/kernels/_lk_pallas_onehot.py:73``, driven by
``lk_track_pairs_pallas`` / ``lk_track_parallel_pallas``).
``lk_level.launches`` counts kernel launches.  ``launch_level`` checks a
level's tensors, allocates the outputs and the launch's work counter (the
kernel's persistent warps take slots from it, so it starts at 0 at every
launch) and calls a C entry point through ``_launch.launch``; kernel C
(``lk_band_cuda.py``) launches through it too.

``lk_track_parallel`` and ``lk_track_pairs`` mirror the JAX package's: the
top level starts at the source position (or ``init_pts``), guesses double
between levels, status demotes only at level 0, and slots that are not
valid come back with their input position and status False.
"""

from __future__ import annotations

import ctypes

import torch

from meshflow_tpu_torch.kernels import _build, _launch
from meshflow_tpu_torch.kernels.lk import HALF, PAD, lk_level_plain

__all__ = ["lk_level", "lk_level_plain", "lk_track_parallel", "lk_track_pairs"]


def launch_level(
    entry: str,
    args,
    rows: int,
    cols: int,
    shifted: bool,
    max_iters: int,
    eps: float,
    min_eig_threshold: float,
    is_level0: bool,
    *extra,
):
    """Check one level's CUDA tensors and launch the C entry point `entry`
    of the kernel library on them (kernels A and C take the same tensors);
    `extra` are the entry point's ints after is_level0.  Returns (corners,
    status)."""
    prev_planes, next_planes, pts, guess, valid, status_in = args
    device = prev_planes.device
    if device.type != "cuda" or any(a.device != device for a in args):
        raise ValueError(f"{entry}: all tensors must be on one CUDA device")
    f, s, c, hpad, wpad = prev_planes.shape
    t, s2, k, two = pts.shape
    if (
        prev_planes.dtype != torch.uint8
        or next_planes.dtype != torch.uint8
        or next_planes.shape[1:] != prev_planes.shape[1:]
        or s2 != s or two != 2
        or guess.shape != pts.shape
        or valid.shape != (t, s, k) or status_in.shape != (t, s, k)
        or pts.dtype != torch.float32 or guess.dtype != torch.float32
        or valid.dtype != torch.bool or status_in.dtype != torch.bool
        or hpad != rows + 2 * PAD or wpad != cols + 2 * PAD
        or not 1 <= c <= 3
    ):
        raise ValueError(f"{entry}: unsupported shapes or dtypes")
    shift = 1 if shifted else 0
    if t + shift > f or t + shift > next_planes.shape[0]:
        raise ValueError(f"{entry}: more pairs than planes")
    args = [a.contiguous() for a in args]
    corner = torch.empty_like(args[2])
    status = torch.empty_like(args[5])
    counter = torch.zeros(1, dtype=torch.int32, device=device)
    _launch.launch(
        entry, device, *args, corner, status, counter,
        t, s, k, c, hpad, wpad, rows, cols, shift, max_iters,
        float(eps) * float(eps), float(min_eig_threshold), bool(is_level0), *extra,
    )
    return corner, status


def lk_level(
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
):
    """One LK pyramid level for all (pair, tile, feature) slots; the
    arguments and results of ``lk_level_plain``."""
    args = (prev_planes, next_planes, pts, guess, valid, status_in)
    if all(a.device.type == "cpu" for a in args):
        return lk_level_plain(
            *args, rows, cols, shifted, max_iters, eps, min_eig_threshold,
            is_level0,
        )
    out = launch_level(
        "meshflow_lk_level", args, rows, cols, shifted, max_iters, eps,
        min_eig_threshold, is_level0,
    )
    _launch.count(lk_level)
    return out


lk_level.launches = 0


def occupancy(channels: int = 3):
    """Kernel A's launch shape on the current card at `channels`: resident
    warps per SM, shared bytes per block, warps per block, registers per
    thread."""
    out = [ctypes.c_int() for _ in range(4)]
    _build.check(
        _build.library().meshflow_lk_level_occupancy(channels, *map(ctypes.byref, out)),
        "lk_level occupancy",
    )
    return tuple(v.value for v in out)


def lk_track_parallel(
    prev_levels,
    next_levels,
    level_dims,
    pts: torch.Tensor,
    valid: torch.Tensor,
    shifted: bool = False,
    max_iters: int = 30,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-4,
    init_pts: torch.Tensor | None = None,
    level_fn=None,
):
    """Track pts of prev pyramid t into next pyramid t (t+1 if shifted).

    prev_levels/next_levels: per level (F, S, C, rows+2*PAD, cols+2*PAD)
    uint8; level_dims: per level (rows, cols); pts: (T, S, K, 2) tile-local
    level-0 positions; valid: (T, S, K) bool.  Returns (next_pts, status).
    Each level runs the kernel that ``MESHFLOW_LK_FETCH`` names when this
    call starts (``kernels/lk_fetch.py``); level_fn, when given, replaces it
    at every level (``lk_level_plain`` holds a kernel's result against the
    plain version on the same device).
    """
    from meshflow_tpu_torch.kernels import lk_fetch

    route = lk_fetch.fetch_route()
    max_level = len(prev_levels) - 1
    status = valid
    start = pts if init_pts is None else init_pts
    next_pts = start / (2.0**max_level)
    for level in range(max_level, -1, -1):
        rows_l, cols_l = level_dims[level]
        prev_l = pts / (2.0**level) - HALF
        if level != max_level:
            next_pts = next_pts * 2.0
        fn = level_fn or lk_fetch.level_function(route, top=(level == max_level))
        corner, status = fn(
            prev_levels[level],
            next_levels[level],
            prev_l,
            next_pts - HALF,
            valid,
            status,
            rows=rows_l,
            cols=cols_l,
            shifted=shifted,
            max_iters=max_iters,
            eps=eps,
            min_eig_threshold=min_eig_threshold,
            is_level0=(level == 0),
        )
        next_pts = corner + HALF
    out = torch.where(valid[..., None], next_pts, pts)
    return out, status & valid


def lk_track_pairs(levels, level_dims, pts, valid, **kwargs):
    """Track each frame's keypoints into the next frame: (F-1) pairs."""
    return lk_track_parallel(
        levels, levels, level_dims, pts[:-1], valid[:-1], shifted=True, **kwargs
    )
