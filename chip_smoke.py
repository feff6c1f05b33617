#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels from ``meshflow_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernel A (LK level): the kernel against its plain PyTorch version on
   the card, on textured tiles with known shifts at the main path's tile
   shapes (16 tiles of 90x160, 3 channels, 512 slots, 3 levels): 8 pairs
   (the earlier kernel table's case) and the main path's launches, a
   63-pair motion block, a 64-frame metric block (shifted=False) and a
   1-pair online step; device time per launch beside the plain version's
   and the bound, and the launch shape (warps per SM, registers);
4. kernel B (backward map): the kernel against its plain version, maps,
   coverage and crop edges equal, on a 64-frame 640x360 block with a
   16x16 mesh (the main path's launch), a single 640x360 frame (online's
   launch), a 1920x1080 frame with a 64x64 mesh, a heavy warp and
   degenerate quads; a digest of its outputs; device ms, host-clock ms per
   call and the plain version's ms at the first three;
5. kernel C (LK level, staged footprint): against the plain version and
   bit for bit against kernel A, at the 640x360 tiles (8 pairs and the
   63-pair motion block) and at 1080p track_downscale=1 tiles (16 of
   270x480, 4 levels, shifts to +-20 px), with the launch shapes of both
   kernels;
6. the main path: ``MeshFlowStabilizer(device="cuda")._stabilize_frames``
   on a synthetic 300-frame 640x360 clip (seeded texture, smooth pan and
   per-frame jitter), cold then warm, with every kernel's launch count;
7. the 1080p path: a 300-frame 1920x1080 clip at the automatic track
   geometry (d=3) with MESHFLOW_LK_FETCH=band, cold then warm, a third
   pass with its stages timed, kernel C's launch count;
8. the 1080p track_downscale=1 control beside d=3 on the clip's first 64
   frames: wall time and the three metrics of each;
9. online mode: ``OnlineMeshFlowStabilizer(device="cuda").process`` over
   a 120-frame 640x360 clip, per-frame latency, launch counts, and a
   stabilized path smoother than the raw one;
10. the main path on a small clip on the card and on the CPU (plain
   versions), whose outputs must agree;
11. the probes: ``python -m meshflow_tpu_torch.probes`` with the six
   probe kernels' launch counts set to 0 before it (probe F also on
   general float32 values), then each probe kernel against its plain
   version, bit for bit (probe D's fine select with a one-hot and a random
   selection at 4 to 128 features and 1 to 50 rounds; probe E at every
   start of its plane and at widths 4 to 1024).

Each kernel's bound is the larger of its operations over the H100's
float32 rate and its bytes over its memory rate; for the LK kernels the
plain version counts the iterations the inputs need, for kernel B the
lookups, homographies and bbox tests its pixels need (``return_work``).  Times, bounds and launches are per
kernel launch (an LK track of 3 levels is 3 launches; kernel B's entry
point is one launch of its table kernel and one of its map kernel); an LK
kernel's `ms` is at the main path's motion launch, `ms_8_pairs` at the
8-pair case; kernel B's at the main path's launch, beside `host_ms`,
`ms_online`, `host_ms_online` and `ms_1080p_mesh64`.  Prints one JSON
line of the kernels' launches, errors, times and bounds, then the last
line ``{"ok": true, "device": {...}}``.  Any failed check or error exits
non-zero before that line.  Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.

    python3 chip_smoke.py --compare DIR

times another checkout of the repo (DIR, for example an earlier commit
unpacked with ``git archive``) against this one on the same card: kernel
A on the 8-pair inputs of step 3, kernels A and C per launch at step 3's
cases, kernel B at step 4's cases (device and host-clock ms per call at
the timed ones), and the 640x360 main path (cold, then three warm
passes), each tree in a process of its own, in the order DIR, this, this,
DIR.  It checks that both trees give the same bytes (kernel A's track,
kernel B's outputs, the main path's output and the timed probe kernels'
outputs) and prints the times.  ``--parts lk,bmap,main,probes`` runs only
the parts named; ``probes`` times probe D's copy and fine select at 16,
64 and 128 features and probe E at the probe's r0, beside the PyTorch
calls of the same functions.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SEED = 0


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def device_ms(fn, launches: int = 5, batches: int = 5) -> float:
    """Device ms per call of fn(), as every kernel time of this script is
    taken: the probes' ``event_ms`` (CUDA events around `launches` calls
    queued behind a spin kernel, median over `batches`)."""
    from meshflow_tpu_torch.probes.__main__ import event_ms

    return event_ms(fn, launches=launches, batches=batches)[0]


class fetch_route:
    """MESHFLOW_LK_FETCH set to `route` inside the block only."""

    def __init__(self, route):
        self.route = route

    def __enter__(self):
        os.environ["MESHFLOW_LK_FETCH"] = self.route

    def __exit__(self, *exc):
        os.environ.pop("MESHFLOW_LK_FETCH", None)


def reset_launches():
    from meshflow_tpu_torch.kernels import bmap_cuda, lk_band_cuda, lk_cuda

    lk_cuda.lk_level.launches = 0
    lk_band_cuda.lk_level_band.launches = 0
    bmap_cuda.backward_map.launches = 0


def read_launches():
    from meshflow_tpu_torch.kernels import bmap_cuda, lk_band_cuda, lk_cuda

    return {"lk_level": lk_cuda.lk_level.launches,
            "lk_band": lk_band_cuda.lk_level_band.launches,
            "backward_map": bmap_cuda.backward_map.launches}


def blurred_noise(rng, shape, passes: int = 2):
    """Seeded uint8 texture: integer noise smoothed by [1 2 1]/4 passes."""
    import numpy as np

    base = rng.integers(0, 256, shape).astype(np.float32)
    for _ in range(passes):
        for ax in (0, 1):
            base = 0.25 * np.roll(base, 1, ax) + 0.5 * base + 0.25 * np.roll(base, -1, ax)
    return base


# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the
# tensor cores and HBM3 bandwidth.  A kernel's bound is the larger of its
# operations over their rate and its bytes over the memory's.
H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12

# Float operations the LK function needs (not what a kernel happens to
# repeat).  Setting up the frozen prev window: one Scharr pair (18) at
# each of the (WIN+1)^2 support points per channel, then per window texel
# an image bilinear (9), two gradient bilinears (18) and three products
# and sums (6).  One iteration per window texel: a bilinear (9), a
# difference (1) and two products and sums (4).
LK_SCHARR_OPS = 18
LK_SETUP_OPS = 33
LK_ITER_OPS = 14


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the least time the card could take."""
    t_ops, t_bytes = ops / H100_F32_FLOPS, nbytes / H100_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def lk_case(device, pairs, th, tw, max_level, max_shift, seed):
    """Seeded textured tiles with known integer shifts: 16 tiles, C=3,
    512 slots; returns (planes, dims, pts, valid, shifts).  The canvas and
    its margin are those of kernel A's first check, so that check's inputs
    stay the same."""
    import numpy as np
    import torch

    from meshflow_tpu_torch.kernels.lk import reflect_pad_level
    from meshflow_tpu_torch.kernels.pyramid import build_pyramid, pyramid_shapes

    rng = np.random.default_rng(seed)
    s, c, k = 16, 3, 512
    margin = 30  # a tile starts up to max_shift + 3 px either side of it
    check(max_shift + 3 <= margin, f"shift {max_shift} leaves the canvas")
    base = blurred_noise(rng, (th + 80, tw + 80, c))
    shifts = [(0, 0)] + [
        tuple(rng.integers(-max_shift, max_shift + 1, 2)) for _ in range(pairs)
    ]
    tiles = np.zeros((pairs + 1, s, c, th, tw), np.float32)
    for t, (dy, dx) in enumerate(shifts):
        for si in range(s):
            oy, ox = margin + dy + (si % 4), margin + dx - (si // 4)
            tiles[t, si] = base[oy : oy + th, ox : ox + tw].transpose(2, 0, 1)
    tiles = torch.from_numpy(np.round(tiles)).to(device)
    planes = tuple(
        reflect_pad_level(lvl).to(torch.uint8)
        for lvl in build_pyramid(tiles, max_level)
    )
    dims = tuple(pyramid_shapes(th, tw, max_level))
    pts = np.stack(
        [rng.uniform(3, tw - 4, (pairs + 1, s, k)), rng.uniform(3, th - 4, (pairs + 1, s, k))],
        axis=-1,
    ).astype(np.float32)
    pts = torch.from_numpy(pts).to(device)
    valid = torch.from_numpy(rng.random((pairs + 1, s, k)) < 0.9).to(device)
    return planes, dims, pts, valid, shifts


class LkCase:
    """One LK track on `lk_case` inputs (16 tiles x 3 channels x 512 slots
    a pair): `pairs` adjacent pairs (shifted=True, as a motion block), or
    with shifted=False frame t of the first pyramid against frame t of a
    second (here frames 1.. of the same tiles), started at init_pts, as a
    metric block's launch.  A track is `levels` launches."""

    def __init__(self, device, name, pairs, shifted=True, th=90, tw=160, max_level=2,
                 max_shift=6, seed=SEED):
        self.name, self.shifted, self.levels = name, shifted, max_level + 1
        self.shape = f"{pairs} pairs, 16 tiles {th}x{tw}x3, K 512, {self.levels} levels" + (
            "" if shifted else ", shifted=False, init_pts")
        (self.planes, self.dims, self.pts, self.valid,
         self.shifts) = lk_case(device, pairs, th, tw, max_level, max_shift, seed)
        self.plain = None  # (corners, status, bound_ms, bound_by, stats), from lk_plain

    def track(self, level_fn=None):
        """The track with `level_fn` at every level (None: the kernel that
        MESHFLOW_LK_FETCH names)."""
        from meshflow_tpu_torch.kernels import lk_cuda

        p = self.planes
        if self.shifted:
            return lk_cuda.lk_track_pairs(p, self.dims, self.pts, self.valid, level_fn=level_fn)
        pts = self.pts[:-1]
        return lk_cuda.lk_track_parallel(
            tuple(x[:-1] for x in p), tuple(x[1:] for x in p), self.dims, pts,
            self.valid[:-1], init_pts=pts, level_fn=level_fn,
        )


def lk_plain(case):
    """The plain track of `case` and the bound of one of its launches, kept
    on the case: the plain version counts the steps these inputs need,
    level by level; the planes are read once, the slots' inputs and outputs
    once per level.  Returns (corners, status, bound_ms, bound_by, stats),
    stats per launch (setups, steps)."""
    import torch

    from meshflow_tpu_torch.kernels.lk import WIN, lk_level_plain

    if case.plain is not None:
        return case.plain
    stats = {"setups": 0, "iters": 0, "slot_bytes": 0}

    def counting(*args, **kwargs):
        corner, status, iters = lk_level_plain(*args, **kwargs, return_iters=True)
        valid = args[4]
        stats["setups"] += int(valid.sum())
        stats["iters"] += int(iters.sum())
        stats["slot_bytes"] += valid.numel() * (2 * 8 + 2 + 9)
        return corner, status

    pp, pst = case.track(counting)
    torch.cuda.synchronize()
    channels = case.planes[0].shape[2]
    setup = channels * (LK_SCHARR_OPS * (WIN + 1) ** 2 + LK_SETUP_OPS * WIN * WIN)
    ops = stats["setups"] * setup + stats["iters"] * channels * WIN * WIN * LK_ITER_OPS
    nbytes = sum(p.numel() for p in case.planes) + stats["slot_bytes"]
    ms, by = bound(ops / case.levels, nbytes / case.levels)
    per_launch = {key: stats[key] / case.levels for key in ("setups", "iters")}
    case.plain = (pp, pst, ms, by, per_launch)
    return case.plain


def lk_gates(name, kp, kst, pp, pst, pts, valid, shifts):
    """A kernel's track against the plain track: A's gates.  Returns
    (status agreement, p99, max endpoint distance, median shift error)."""
    import torch

    pairs = len(shifts) - 1
    v = valid[:-1]
    agree = (kst == pst)[v].float().mean().item()
    both = kst & pst
    dist = torch.linalg.norm(kp - pp, dim=-1)[both]
    p99 = torch.quantile(dist, 0.99).item()
    max_err = dist.max().item()
    inv = ~v
    untouched = bool(torch.equal(kp[inv], pts[:-1][inv])) and not bool(kst[inv].any())
    # known shifts: pair t moves content by -(shift[t+1] - shift[t])
    expect = torch.tensor(
        [[-(shifts[t + 1][1] - shifts[t][1]), -(shifts[t + 1][0] - shifts[t][0])]
         for t in range(pairs)], dtype=torch.float32, device=kp.device,
    )[:, None, None, :]
    err_shift = torch.median(
        torch.linalg.norm((kp - pts[:-1] - expect)[both], dim=-1)
    ).item()
    print(
        f"{name}: valid {int(v.sum())} status agreement {agree:.5f} "
        f"p99 endpoint {p99:.6f} px max {max_err:.6f} px "
        f"median |track - known shift| {err_shift:.4f} px, tracked {int(both.sum())}"
    )
    check(agree >= 0.99, f"{name} status agreement {agree} < 0.99")
    check(p99 <= 0.02, f"{name} p99 endpoint distance {p99} > 0.02 px")
    check(untouched, f"{name} changed invalid slots")
    check(err_shift < 0.1, f"{name} misses the known shifts by {err_shift} px")
    return agree, p99, max_err, err_shift



def lk_cases(device):
    """The LK cases of kernels A and C: the 8-pair case of the earlier
    kernel table, and the main path's launches at 640x360 (16 tiles of
    90x160x3, K 512, 3 levels): a motion block (api.CHUNK - 1 = 63 pairs),
    a metric block (64 frames, shifted=False) and an online step (1 pair,
    8,192 slots)."""
    return {
        "8 pairs": LkCase(device, "8 pairs", 8),
        "motion": LkCase(device, "motion", 63, seed=SEED + 2),
        "metric": LkCase(device, "metric", 64, shifted=False, seed=SEED + 3),
        "online": LkCase(device, "online", 1, seed=SEED + 4),
    }


def phase_kernel_a(device, cases):
    """LK kernel vs plain LK on the card at every case of `lk_cases`:
    gates, device time per launch beside the plain version's and the bound,
    the launch shape (warps per SM, registers)."""
    from meshflow_tpu_torch.kernels import lk_cuda

    warps, smem, per_block, regs = lk_cuda.occupancy(3)
    print(f"kernel A launch at C=3: {warps} warps/SM ({per_block} a block, {smem} B shared a "
          f"block), {regs} registers/thread; at C=1: {lk_cuda.occupancy(1)}")
    out = {"max_abs_err": 0.0, "warps_per_sm": warps, "regs": regs}
    for name, case in cases.items():
        kp, kst = case.track(lk_cuda.lk_level)
        pp, pst, bound_ms, bound_by, stats = lk_plain(case)
        _, _, max_err, _ = lk_gates(f"kernel A {name}", kp, kst, pp, pst, case.pts,
                                    case.valid, case.shifts)
        levels = case.levels
        ms = device_ms(lambda: case.track(lk_cuda.lk_level)) / levels
        big = name in ("motion", "metric")
        plain_ms = device_ms(lambda: case.track(lk_cuda.lk_level_plain), launches=1,
                             batches=1 if big else 3) / levels
        print(f"kernel A {name} per launch ({case.shape}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); per launch "
              f"{stats['setups']:.0f} set-ups, {stats['iters']:.0f} steps")
        out["max_abs_err"] = max(out["max_abs_err"], max_err)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, **stats}
    main = out["motion"]  # the main path's launch
    out.update(ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=None,
               ms_8_pairs=out["8 pairs"]["ms"], ms_metric=out["metric"]["ms"],
               ms_online=out["online"]["ms"])
    return out


def phase_kernel_c(device, motion):
    """Kernel C vs the plain version and vs kernel A on the card, at the
    640x360 slice's tiles (8 pairs, and the main path's 63-pair motion
    launch `motion`) and at 1080p track_downscale=1 tiles with shifts up to
    +-20 px (the top level re-stages its patch)."""
    import torch

    from meshflow_tpu_torch.kernels import lk_band_cuda, lk_cuda
    from meshflow_tpu_torch.kernels.lk import PAD

    out = {"max_abs_err": 0.0}
    cases = {
        "640x360": LkCase(device, "640x360", 8, seed=SEED + 1),
        "1080p-d1": LkCase(device, "1080p-d1", 4, th=270, tw=480, max_level=3, max_shift=20,
                           seed=SEED + 1),
        "motion": motion,
    }
    for name, case in cases.items():
        def band():
            with fetch_route("band"):
                return case.track()

        before = lk_band_cuda.lk_level_band.launches
        cp, cst = band()
        check(lk_band_cuda.lk_level_band.launches == before + case.levels,
              "kernel C launch count of one track")
        ap, ast = case.track(lk_cuda.lk_level)
        pp, pst, bound_ms, bound_by, stats = lk_plain(case)
        _, _, max_err, _ = lk_gates(f"kernel C {name}", cp, cst, pp, pst, case.pts,
                                    case.valid, case.shifts)
        same_as_a = bool(torch.equal(cp, ap)) and bool(torch.equal(cst, ast))
        print(f"kernel C {name}: corners and status bit-identical to kernel A: {same_as_a}")
        check(same_as_a, f"kernel C differs from kernel A ({name})")
        levels = case.levels
        ms = device_ms(band) / levels
        a_ms = device_ms(lambda: case.track(lk_cuda.lk_level)) / levels
        plain_ms = device_ms(lambda: case.track(lk_cuda.lk_level_plain), launches=1,
                             batches=1 if name == "motion" else 3) / levels
        dims = case.dims
        top, low = (
            lk_band_cuda.occupancy(3, patch, dims[lvl][0] + 2 * PAD, dims[lvl][1] + 2 * PAD)
            for patch, lvl in ((lk_band_cuda.PN_TOP, levels - 1), (lk_band_cuda.PN_LOWER, 0))
        )
        print(
            f"kernel C {name} per launch ({case.shape}): kernel C {ms:.4f} ms, kernel A "
            f"{a_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"per launch {stats['setups']:.0f} set-ups, {stats['iters']:.0f} steps; (warps/SM, "
            f"shared B/block, warps/block, registers): C top {top}, C lower {low}, "
            f"A {lk_cuda.occupancy(3)}"
        )
        out["max_abs_err"] = max(out["max_abs_err"], max_err)
        out[name] = {"ms": ms, "a_ms": a_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "top": top, "lower": low}
    main = out["motion"]  # the tiles the 1080p path tracks at d=3, at its launch
    out.update(ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=None, ms_8_pairs=out["640x360"]["ms"])
    return out


# Operations kernel B's outputs need (its bound), per pixel, as the plain
# version counts what its data needs (``return_work``): each cell lookup
# is a few operations an axis (a compare, a min, a floor, a multiply and a
# shift, a clamp: 5); each homography applied to the pixel 13 (6 products,
# 4 sums, the clamp, 2 divisions); each candidate's bbox test 8.  Per cell
# of each frame, the table: two unit-square maps of 35 operations, the
# adjugate (27) and the 3x3 product (45).
BMAP_LOOKUP_OPS = 2 * 5
BMAP_HOMOGRAPHY_OPS = 13
BMAP_BBOX_OPS = 8
BMAP_CELL_OPS = 2 * 35 + 27 + 45

# Kernel B's cases: name -> (width, height, mesh, vertex noise sigma,
# frames, degenerate quads).  The first three are timed: the main path's
# launch (a 64-frame render block at 640x360), online mode's (one frame)
# and a 1080p frame on a 64x64 mesh.
BMAP_CASES = {
    "main": (640, 360, 16, 1.5, 64, False),
    "online": (640, 360, 16, 1.5, 1, False),
    "1080p/64": (1920, 1080, 64, 3.0, 1, False),
    "heavy warp": (640, 360, 16, 12.0, 1, False),
    "degenerate": (640, 360, 16, 3.0, 4, True),
}
BMAP_TIMED = ("main", "online", "1080p/64")


def degenerate_quads(stab):
    """Corner positions with degenerate cells: a vertex collapsed onto its
    right neighbour and one onto its diagonal neighbour (den 0, clamped),
    a cell shrunk to a point, and vertices pushed far outside the frame
    (5e3 and 1e6 px, and 1e30, which overflows the cell's table)."""
    import torch

    out = stab.clone()
    r, c = out.shape[-3] - 1, out.shape[-2] - 1
    out[..., 1, 1, :] = out[..., 1, 2, :]
    out[..., r - 1, 1, :] = out[..., r, 2, :]
    out[..., 2, c - 1, :] = out[..., 2, c, :] = out[..., 3, c - 1, :] = out[..., 3, c, :]
    far = torch.tensor([[5e3, -7e3], [1e6, 1e6], [1e30, -1e30]], device=out.device)
    for k, v in enumerate(far):
        out[..., r - 1 - 2 * k, 3 + 4 * k, :] = v
    return out


def bmap_inputs(device, name):
    """(config, stab_pos, unstab_grid, h, w) of kernel B's case `name`,
    seeded."""
    import numpy as np
    import torch

    from meshflow_tpu_torch.config import MeshFlowConfig
    from meshflow_tpu_torch.utils import grid

    w, h, mesh, sigma, frames, degenerate = BMAP_CASES[name]
    config = MeshFlowConfig(mesh_row_count=mesh, mesh_col_count=mesh)
    rng = np.random.default_rng(SEED + mesh + int(sigma))
    unstab = grid.vertex_grid(config, h, w, device=device)
    shape = (frames,) + tuple(unstab.shape) if frames > 1 else tuple(unstab.shape)
    stab = unstab + torch.from_numpy(rng.normal(0.0, sigma, shape).astype(np.float32)).to(device)
    return config, degenerate_quads(stab) if degenerate else stab, unstab, h, w


def host_clock_ms(fn, calls: int = 20) -> float:
    """Host-clock ms per call: perf_counter around `calls` calls of fn(),
    ending in a synchronize (after one warm call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) / calls * 1e3


def digest(*tensors) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def bmap_times(device, name):
    """(device ms, host-clock ms) per backward_map call at kernel B's case
    `name`."""
    from meshflow_tpu_torch.kernels import bmap_cuda

    config, stab, unstab, h, w = bmap_inputs(device, name)

    def call():
        return bmap_cuda.backward_map(stab, unstab, config, h, w)

    return device_ms(call), host_clock_ms(call)


def phase_kernel_b(device):
    """Kernel B against the plain backward map on the card at every case of
    BMAP_CASES: maps, coverage and crop edges equal; a digest of all its
    outputs; at the timed cases device ms, host-clock ms per call and the
    plain version's device ms; the bound at the main path's launch; the
    map kernel's launch shape at 16x16 and 64x64 meshes."""
    import ctypes

    import torch

    from meshflow_tpu_torch.kernels import _build, bmap_cuda
    from meshflow_tpu_torch.render.stabilize import crop_edges

    shapes = {}
    for mesh in (16, 64):
        vals = [ctypes.c_int() for _ in range(3)]
        _build.check(_build.library().meshflow_bmap_occupancy(
            mesh, mesh, *map(ctypes.byref, vals)), "bmap occupancy")
        shapes[mesh] = tuple(v.value for v in vals)
        print(f"kernel B map launch at a {mesh}x{mesh} mesh: {shapes[mesh][0]} warps/SM, "
              f"{shapes[mesh][1]} B shared a block, {shapes[mesh][2]} registers/thread")
    out = {"max_abs_err": 0.0, "library_ms": None, "warps_per_sm": shapes[16][0],
           "regs": shapes[16][2], "warps_per_sm_mesh64": shapes[64][0]}
    outputs = []
    for name in BMAP_CASES:
        config, stab, unstab, h, w = bmap_inputs(device, name)
        kb = bmap_cuda.backward_map(stab, unstab, config, h, w)
        pb, work = bmap_cuda.backward_map_plain(stab, unstab, config, h, w, return_work=True)
        pixels = pb.covered.numel()
        torch.cuda.synchronize()
        outputs += list(kb)
        equal = [bool(torch.equal(k, p)) for k, p in zip(kb, pb)]
        edges_equal = bool(torch.equal(crop_edges(kb, h, w), crop_edges(pb, h, w)))
        cov = pb.covered
        err = max((k - p)[cov].abs().max().item() if cov.any() else 0.0
                  for k, p in zip(kb[:2], pb[:2]))
        line = (f"kernel B {name} ({w}x{h}, mesh {config.mesh_row_count}, "
                f"{stab.shape[0] if stab.dim() == 4 else 1} frame(s)): map_x, map_y, covered "
                f"equal {equal} (uncovered {int((~cov).sum())} px), crop edges equal "
                f"{edges_equal}, max map err {err:.3g}; a pixel needs " + ", ".join(
                    f"{v.sum().item() / pixels:.4f} {k}" for k, v in work.items()))
        check(all(equal), f"kernel B outputs differ from the plain version ({name})")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        check(edges_equal, f"kernel B crop edges differ ({name})")
        if name in BMAP_TIMED:
            ms, host_ms = bmap_times(device, name)
            plain_ms = device_ms(
                lambda: bmap_cuda.backward_map_plain(stab, unstab, config, h, w),
                launches=1, batches=3)
            line += f"; kernel {ms:.4f} ms (host clock {host_ms:.4f} ms), plain {plain_ms:.4f} ms"
            out[name] = {"ms": ms, "host_ms": host_ms, "plain_ms": plain_ms}
        if name == "main":
            frames, cells = stab.shape[0], config.mesh_row_count * config.mesh_col_count
            count = {k: int(v.sum()) for k, v in work.items()}
            ops = (BMAP_LOOKUP_OPS * count["lookups"] + BMAP_HOMOGRAPHY_OPS * count["homographies"]
                   + BMAP_BBOX_OPS * count["candidates"] + BMAP_CELL_OPS * frames * cells)
            nbytes = (stab.numel() + unstab.numel()) * 4 + 9 * pixels
            out["bound_ms"], out["bound_by"] = bound(ops, nbytes)
            full, _ = bound((4 * BMAP_LOOKUP_OPS + 12 * BMAP_HOMOGRAPHY_OPS + 9 * BMAP_BBOX_OPS)
                            * pixels + BMAP_CELL_OPS * frames * cells, nbytes)
            line += (f"; bound {out['bound_ms']:.4f} ms ({out['bound_by']}; every step and "
                     f"all 9 candidates a pixel: {full:.4f} ms)")
        print(line)
    out["digest"] = digest(*outputs)
    print(f"kernel B outputs digest {out['digest']}")
    main = out.pop("main")
    out.update(ms=main["ms"], host_ms=main["host_ms"], plain_ms=main["plain_ms"],
               ms_online=out["online"]["ms"], host_ms_online=out["online"]["host_ms"],
               ms_1080p_mesh64=out["1080p/64"]["ms"],
               host_ms_1080p_mesh64=out["1080p/64"]["host_ms"])
    for name in BMAP_TIMED[1:]:
        out.pop(name)
    return out


def synthetic_clip(num_frames: int, h: int, w: int, pan: int):
    """Seeded BGR clip: integer-shift crops of one textured canvas, a smooth
    pan of `pan` px to the right over the clip plus +-3 px jitter."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    margin = 40
    small = rng.integers(0, 256, ((h + 2 * margin) // 4 + 1, (w + pan + 2 * margin) // 4 + 1, 3))
    canvas = np.repeat(np.repeat(small, 4, 0), 4, 1).astype(np.float32)
    for _ in range(2):
        for ax in (0, 1):
            canvas = 0.25 * np.roll(canvas, 1, ax) + 0.5 * canvas + 0.25 * np.roll(canvas, -1, ax)
    canvas = np.round(canvas).astype(np.uint8)
    frames = np.empty((num_frames, h, w, 3), np.uint8)
    for t in range(num_frames):
        jx, jy = rng.integers(-3, 4, 2)
        x0 = margin + int(round(pan * t / max(num_frames - 1, 1))) + jx
        y0 = margin + jy
        frames[t] = canvas[y0 : y0 + h, x0 : x0 + w]
    return frames


def phase_main_path(device, num_frames=300, h=360, w=640, pan=120):
    """The port's main path on a 300-frame 640x360 clip, cold then warm."""
    import math

    import torch

    from meshflow_tpu_torch.api import MeshFlowStabilizer

    frames = torch.from_numpy(synthetic_clip(num_frames, h, w, pan=pan)).to(device)
    stab = MeshFlowStabilizer(device=device)
    variant = MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL

    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    cropped, ratio, distortion, stability = stab._stabilize_frames(frames, variant)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - start
    launches = read_launches()

    start = time.perf_counter()
    cropped2, *_ = stab._stabilize_frames(frames, variant)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - start

    chunk = stab.CHUNK
    levels = stab.config.lk_max_level(h, w) + 1
    motion_blocks = math.ceil((num_frames - 1) / (chunk - 1))
    metric_blocks = math.ceil(num_frames / chunk)
    crop = stab.last_crop.tolist()
    disp = stab.last_motion.displacements
    mean_dx = disp[-1, ..., 0].mean().item()
    ratio, distortion, stability = float(ratio), float(distortion), float(stability)
    print(
        f"main path: {num_frames} frames {w}x{h}: cold {cold_s:.3f} s, warm "
        f"{warm_s:.3f} s ({num_frames / warm_s:.2f} fps warm); launches {launches}; "
        f"crop {crop}; cropping ratio {ratio:.6f}, distortion {distortion:.6f}, "
        f"stability {stability:.6f}; last-frame mean x displacement {mean_dx:.3f} px"
    )
    check(
        launches["lk_level"] == levels * (motion_blocks + metric_blocks),
        f"kernel A ran {launches['lk_level']} times, expected "
        f"{levels} levels x ({motion_blocks} motion + {metric_blocks} metric blocks)",
    )
    check(launches["backward_map"] == metric_blocks, "kernel B launch count")
    check(launches["lk_band"] == 0, "kernel C ran on the default route")
    check(
        tuple(cropped.shape) == (num_frames, h, w, 3)
        and cropped.dtype == torch.uint8 and cropped.device.type == device,
        f"output {tuple(cropped.shape)} {cropped.dtype} {cropped.device}",
    )
    check(torch.equal(cropped, cropped2), "warm pass output differs from cold pass")
    left, top, right, bottom = crop
    check(0 <= left < right <= w - 1 and 0 <= top < bottom <= h - 1, f"crop {crop}")
    check(all(math.isfinite(x) for x in (ratio, distortion, stability)), "metrics not finite")
    check(0.0 <= stability <= 1.0, f"stability {stability} outside [0, 1]")
    # the camera pans right, so content (and the vertex displacement) moves left
    check(mean_dx < -pan / 2, f"mean displacement {mean_dx} does not follow the pan")
    return launches, cold_s, warm_s


def check_output(name, stab, out, num_frames, h, w, pan, device):
    """Shape, type, device, crop inside the frame, finite metrics with
    stability in [0, 1], and the mean displacement following the pan."""
    import math

    import torch

    cropped, ratio, distortion, stability = out
    check(
        tuple(cropped.shape) == (num_frames, h, w, 3)
        and cropped.dtype == torch.uint8 and cropped.device.type == device,
        f"{name}: output {tuple(cropped.shape)} {cropped.dtype} {cropped.device}",
    )
    crop = stab.last_crop.tolist()
    left, top, right, bottom = crop
    check(0 <= left < right <= w - 1 and 0 <= top < bottom <= h - 1, f"{name}: crop {crop}")
    metrics = tuple(float(x) for x in (ratio, distortion, stability))
    check(all(math.isfinite(x) for x in metrics), f"{name}: metrics {metrics} not finite")
    check(0.0 <= metrics[2] <= 1.0, f"{name}: stability {metrics[2]} outside [0, 1]")
    # the camera pans right, so content (and the vertex displacement) moves left
    mean_dx = stab.last_motion.displacements[-1, ..., 0].mean().item()
    check(mean_dx < -pan / 2, f"{name}: mean displacement {mean_dx} does not follow the pan")
    return crop, metrics, mean_dx


def phase_1080p(device, num_frames=300, h=1080, w=1920, pan=360):
    """The 1080p path, automatic track geometry (d=3: tracking at 640x360),
    with kernel C (MESHFLOW_LK_FETCH=band for this phase only), cold, warm,
    then a third pass that times its stages."""
    import math

    import torch

    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.utils.profiling import StageTimer

    frames = torch.from_numpy(synthetic_clip(num_frames, h, w, pan=pan)).to(device)
    stab = MeshFlowStabilizer(device=device)
    config = stab.config
    th, tw = config.track_shape(h, w)
    with fetch_route("band"):
        reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = stab._stabilize_frames(frames, 0)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - start
        launches = read_launches()
        start = time.perf_counter()
        out2 = stab._stabilize_frames(frames, 0)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - start
        # a third pass for the stages: the timer synchronizes at each stage end
        stab._stabilize_frames(frames, 0, StageTimer(enabled=True, device=device))
    crop, metrics, mean_dx = check_output("1080p", stab, out, num_frames, h, w, pan, device)
    stages = {name: round(sec, 4) for name, sec in stab.last_timer.stages}
    chunk = stab.CHUNK
    levels = config.lk_max_level(th, tw) + 1
    blocks = math.ceil((num_frames - 1) / (chunk - 1)), math.ceil(num_frames / chunk)
    print(
        f"1080p path (d={config.resolve_track_downscale(h, w)}, tracking {tw}x{th}, band): "
        f"{num_frames} frames {w}x{h}: cold {cold_s:.3f} s, warm {warm_s:.3f} s "
        f"({num_frames / warm_s:.2f} fps warm); launches {launches}; crop {crop}; "
        f"cropping ratio {metrics[0]:.6f}, distortion {metrics[1]:.6f}, stability "
        f"{metrics[2]:.6f}; last-frame mean x displacement {mean_dx:.3f} px; "
        f"third pass stages (s) {stages}"
    )
    check(launches["lk_band"] == levels * sum(blocks),
          f"kernel C ran {launches['lk_band']} times, expected {levels} levels x "
          f"({blocks[0]} motion + {blocks[1]} metric blocks)")
    check(launches["lk_level"] == 0, "kernel A ran under MESHFLOW_LK_FETCH=band")
    check(launches["backward_map"] == blocks[1], "kernel B launch count (1080p)")
    check(torch.equal(out[0], out2[0]), "1080p warm pass output differs from cold pass")
    return launches, frames[:64]


def phase_1080p_control(device, frames, pan):
    """64 frames of the 1080p clip at track_downscale=1 (270x480 tiles, 4
    levels) and at the automatic d=3, both with kernel C."""
    import torch

    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.config import MeshFlowConfig

    num_frames, h, w = frames.shape[:3]
    rows = {}
    for d in (1, 3):
        stab = MeshFlowStabilizer(config=MeshFlowConfig(track_downscale=d), device=device)
        levels = stab.config.lk_max_level(*stab.config.track_shape(h, w)) + 1
        with fetch_route("band"):
            reset_launches()
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = stab._stabilize_frames(frames, 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches = read_launches()
        crop, metrics, _ = check_output(f"1080p d={d}", stab, out, num_frames, h, w, pan, device)
        check(launches["lk_band"] == levels * 2 and launches["lk_level"] == 0,
              f"1080p d={d}: launches {launches}, expected kernel C {levels} x (1 + 1)")
        rows[d] = {"seconds": wall, "fps": num_frames / wall, "crop": crop,
                   "cropping_ratio": metrics[0], "distortion": metrics[1],
                   "stability": metrics[2], "launches": launches}
        print(f"1080p control d={d} ({levels} levels): {num_frames} frames in {wall:.3f} s "
              f"= {num_frames / wall:.2f} fps; crop {crop}; cropping ratio {metrics[0]:.6f}, "
              f"distortion {metrics[1]:.6f}, stability {metrics[2]:.6f}; launches {launches}")
    return rows


def phase_online(device, num_frames=120, h=360, w=640):
    """Online mode on a jittery 640x360 clip with the default fetch."""
    import numpy as np
    import torch

    from meshflow_tpu_torch.online import OnlineMeshFlowStabilizer

    frames = synthetic_clip(num_frames, h, w, pan=60)
    stab = OnlineMeshFlowStabilizer(device=device)
    levels = stab.config.lk_max_level(h, w) + 1
    reset_launches()
    times, outs, c_mean, p_mean = [], [], [], []
    for frame in frames:
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = stab.process(frame)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        outs.append(out)
        state = stab._state
        c_mean.append(state.unstab_window[-1].mean((0, 1)).cpu().numpy())
        p_mean.append(state.stab_window[-1].mean((0, 1)).cpu().numpy())
    launches = read_launches()
    steady = np.asarray(times[10:])
    c_jerk = np.abs(np.diff(np.asarray(c_mean[1:]), 2, axis=0)).mean()
    p_jerk = np.abs(np.diff(np.asarray(p_mean[1:]), 2, axis=0)).mean()
    p50, p90 = np.percentile(steady, 50), np.percentile(steady, 90)
    print(f"online: {num_frames} frames {w}x{h}: first frame {times[0]:.3f} ms, per-frame "
          f"p50 {p50:.3f} ms p90 {p90:.3f} ms (frames 10-{num_frames - 1}); launches "
          f"{launches}; mean |second difference| of the frame-mean path: raw c_t "
          f"{c_jerk:.4f} px, stabilized p_t {p_jerk:.4f} px")
    check(np.array_equal(outs[0], frames[0]), "online: first output differs from first input")
    check(all(o.shape == (h, w, 3) and o.dtype == np.uint8 for o in outs),
          "online: output shape or dtype")
    check(launches["lk_level"] == levels * (num_frames - 1) and launches["lk_band"] == 0,
          f"online: kernel A ran {launches['lk_level']} times, expected {levels} x "
          f"{num_frames - 1}")
    check(launches["backward_map"] == num_frames - 1, "online: kernel B launch count")
    check(p_jerk < c_jerk, f"online: stabilized path {p_jerk} not smoother than {c_jerk}")
    return {"first_ms": times[0], "p50_ms": p50, "p90_ms": p90, "launches": launches}


def phase_small_agreement(device):
    """A small clip through the whole path on the card (kernels) and on the
    CPU (plain versions): same crop, near-equal frames and metrics."""
    import torch

    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.config import MeshFlowConfig

    config = MeshFlowConfig(
        mesh_row_count=8, mesh_col_count=8, mesh_outlier_subframe_row_count=2,
        mesh_outlier_subframe_col_count=2, max_features_per_subframe=128,
    )
    frames = torch.from_numpy(synthetic_clip(12, 180, 320, pan=12))
    outs = {}
    for dev in (device, "cpu"):
        s = MeshFlowStabilizer(config=config, device=dev)
        res = s._stabilize_frames(frames, 0)
        outs[dev] = ([r.cpu() for r in res], s.last_crop.cpu())
    (g, gcrop), (c, ccrop) = outs[device], outs["cpu"]
    mse = ((g[0].double() - c[0].double()) ** 2).mean().item()
    psnr = 99.0 if mse == 0 else 10 * __import__("math").log10(255**2 / mse)
    rel = [abs(float(a) - float(b)) / max(abs(float(b)), 1e-12) for a, b in zip(g[1:], c[1:])]
    print(f"small clip card vs CPU: crop {gcrop.tolist()} vs {ccrop.tolist()}, "
          f"PSNR {psnr:.2f} dB, metric rel diffs {rel}")
    check(torch.equal(gcrop, ccrop), "card and CPU crops differ")
    check(psnr >= 40.0, f"card vs CPU PSNR {psnr} < 40 dB")
    check(max(rel) <= 1e-2, f"card vs CPU metrics differ by {rel}")


# The probe kernels of the kernels line: name -> (CUDA source in csrc/,
# the case the line reports, the Pallas kernel it replaces)
PROBE_KERNELS = {
    "dynslice_copy": ("probe_dynslice_fetch.cu", "B=16", "scripts/probe_dynslice_fetch.py:40"),
    "dynslice_fine": ("probe_dynslice_fetch.cu", "B=16", "scripts/probe_dynslice_fetch.py:57"),
    "onehot_rowsel": ("probe_dynslice_fetch.cu", "B=16", "scripts/probe_dynslice_fetch.py:81"),
    "aligned_dynslice": ("probe_aligned_dynslice.cu", "r0=37",
                         "scripts/probe_aligned_dynslice.py:34"),
    "select_rows": ("probe_select_rows.cu", "rows=432", "scripts/probe_select_rows.py:39"),
    "scalar_from_vmem": ("probe_scalar_from_vmem.cu", "B=8",
                         "scripts/probe_scalar_from_vmem.py:35"),
}


def probe_bound(kernel, case):
    """(bound_ms, bound_by) of one probe launch on the entry point's inputs
    for `case`: the float32 elements its outputs depend on read once, each
    output written once, and the float operations the outputs need.  A D
    launch runs 50 rounds, but the results of copy and fine are the last
    round's, so their bound is one round's; one-hot's sum needs every
    round's 8 x 128 corner and the last round's band.  Fine's operations
    are two per nonzero of rsel and band column; the selects (E, F, G's
    row) need none."""
    import torch

    from meshflow_tpu_torch.probes import (
        aligned_dynslice as e,
        dynslice_fetch as d,
        scalar_from_vmem as g,
        select_rows as f,
    )
    from meshflow_tpu_torch.probes._slices import dyn_start

    n = int(case.split("=")[1].split()[0])
    if kernel in ("dynslice_copy", "dynslice_fine", "onehot_rowsel"):
        idx, plane = d.probe_inputs(n)
        h, w = plane.shape
        read = torch.zeros(h, w, dtype=torch.bool)
        out = 8 * 128
        if kernel == "onehot_rowsel":
            for r in range(d.REPS):
                t = idx[0].long() + r % 4 + torch.arange(8)
                read[t[t < h], :128] = True
            t = idx[0].long() + (d.REPS - 1) % 4 + torch.arange(n * d.PN) % d.PN
            read[t[t < h]] = True
            elems = int(read.sum()) + 1 + out + n * d.PN * w  # plane, idx[0], out, band
            return bound((d.REPS - 1) * out, 4 * elems)
        read[d.band_index(idx, d.REPS - 1, h, w)] = True
        elems = int(read.sum()) + idx.numel() + out + n * d.BAND_R * d.BAND_C
        if kernel == "dynslice_copy":
            return bound(0, 4 * elems)
        rsel = d.one_hot_rsel(n)
        elems += rsel.numel() + n * d.PN * d.BAND_C  # rsel, rows
        return bound(2 * int((rsel != 0).sum()) * d.BAND_C, 4 * elems)
    if kernel == "aligned_dynslice":
        return bound(0, 4 * (1 + 2 * e.ROWS * e.W))  # r0, 16 plane rows, out
    if kernel == "select_rows":
        table, cells = f.probe_inputs(n)
        rows, picks = table.shape[0], cells.numel()
        return bound(0, 4 * (rows * cells.unique().numel() + picks + rows * picks))
    plane, corners = g.probe_inputs()  # scalar_from_vmem
    base = torch.div(torch.floor(2 * corners[:, 0] + 1).long(), 8, rounding_mode="floor") * 8
    rows = dyn_start(base, g.H, 16).unique().numel()
    return bound(2 * n, 4 * (n + rows * g.W + n * g.W))  # corners[:, 0], rows, out


# D's fine select is held bit for bit at these feature counts and rounds
# a launch (1: one round; 2 and 5: both buffer parities; 50: the probe's),
# E at these plane widths
FINE_SIZES = (4, 16, 64, 128)
FINE_REPS = (1, 2, 5, 50)
ALIGNED_WIDTHS = (4, 256, 664, 1024)


def phase_probes(device):
    """The probe entry point (``python -m meshflow_tpu_torch.probes``) on
    the card with the six probe kernels' counts set to 0 before it and
    read after it; then, with launches of their own, each kernel against
    its plain version under the gates, all bit for bit: at the probes'
    sizes and at clamped and wrapped starts (F also on general float32
    values, in the entry point), D's fine select with a one-hot and a
    random selection matrix at FINE_SIZES and FINE_REPS, E at every start
    and ALIGNED_WIDTHS."""
    import numpy as np
    import torch

    from meshflow_tpu_torch.probes import __main__ as entry
    from meshflow_tpu_torch.probes import (
        aligned_dynslice as e,
        dynslice_fetch as d,
        scalar_from_vmem as g,
        select_rows as f,
    )

    wrappers = {
        "dynslice_copy": d.dynslice_copy, "dynslice_fine": d.dynslice_fine,
        "onehot_rowsel": d.onehot_rowsel, "aligned_dynslice": e.aligned_rows,
        "select_rows": f.select_rows, "scalar_from_vmem": g.band_row,
    }
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    results = entry.run(entry.PROBES, device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"probes: entry point {seconds:.3f} s; launches {launches}")
    check(all(n > 0 for n in launches.values()), f"a probe kernel never ran: {launches}")
    for r in results:
        check(r["ok"], f"probe {r['kernel']} {r['case']}: kernel differs from plain "
                       f"(max abs err {r['max_abs_err']}) or the probe's answer is WRONG")
    err = {name: 0.0 for name in PROBE_KERNELS}

    # clamped and wrapped starts, bit-equal
    for b in d.SIZES:
        idx, plane = (t.to(device) for t in d.probe_inputs(b))
        idx[:4] = torch.tensor([320, 640, -16, -100], dtype=torch.int32, device=device)
        for name in ("dynslice_copy", "onehot_rowsel"):
            got, want = getattr(d, name)(idx, plane), getattr(d, name + "_plain")(idx, plane)
            check(all(torch.equal(x, y) for x, y in zip(got, want)), f"{name} B={b} differs")
    # D's fine select bit for bit, one-hot and random rsel, one round, both
    # buffer parities, the probe's 50 rounds
    rng = np.random.default_rng(SEED)
    for b in FINE_SIZES:
        idx, plane = (t.to(device) for t in d.probe_inputs(b))
        idx[:4] = torch.tensor([320, 640, -16, -100], dtype=torch.int32, device=device)
        random = torch.from_numpy(rng.random((b, d.PN, d.BAND_R), np.float32))
        for kind, rsel in (("one-hot", d.one_hot_rsel(b, seed=1)), ("random", random)):
            rsel = rsel.to(device)
            for reps in FINE_REPS:
                got = d.dynslice_fine(idx, plane, rsel, reps)
                want = d.dynslice_fine_plain(idx, plane, rsel, reps)
                err["dynslice_fine"] = max(err["dynslice_fine"], entry.max_abs_err(got, want))
                check(all(torch.equal(x, y) for x, y in zip(got, want)),
                      f"dynslice_fine B={b} {kind} rsel reps={reps} differs "
                      f"(max abs err {entry.max_abs_err(got, want)})")
        print(f"probe D fine B={b}: out, bands and rows equal to the plain version "
              f"(one-hot and random rsel, reps {FINE_REPS})")
    # E at every start of a 256-row plane, wrapped ones too, and at widths
    # past the 512 of shared memory the earlier kernel staged
    for w in ALIGNED_WIDTHS:
        plane = torch.arange(e.H * w, dtype=torch.float32, device=device).reshape(e.H, w)
        for row in range(-3, e.H):
            r0 = torch.tensor([row], dtype=torch.int32, device=device)
            check(torch.equal(e.aligned_rows(plane, r0), e.aligned_rows_plain(plane, r0)),
                  f"aligned_dynslice W={w} r0={row} differs")
    print(f"probe E: equal to the plain version at r0 -3..{e.H - 1}, W {ALIGNED_WIDTHS}")
    plane, _ = (t.to(device) for t in g.probe_inputs())
    corners = g.corners_from([0.0, 3.7, 20.0, 24.0, 27.0, 31.4, -1.2, 10.0]).to(device)
    check(torch.equal(g.band_row(plane, corners), g.band_row_plain(plane, corners)),
          "scalar_from_vmem differs at clamped and wrapped bases")

    out = {}
    for name, (_, case, replaces) in PROBE_KERNELS.items():
        rows = [r for r in results if r["kernel"] == name]
        for r in rows:
            bms, by = probe_bound(name, r["case"])
            library = "none" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms"
            per_round = (f" ({r['ms'] / d.REPS:.6f} ms per round)"
                         if name in ("dynslice_copy", "dynslice_fine") else "")
            print(f"probe {name} {r['case']}: kernel {r['ms']:.5f} ms{per_round} (host enqueue "
                  f"{r['host_ms']:.5f} ms), plain {r['plain_ms']:.5f} ms, library {library}, "
                  f"bound {bms:.6f} ms ({by}), max abs err {r['max_abs_err']}")
        main = next(r for r in rows if r["case"] == case)
        bms, by = probe_bound(name, case)
        out[name] = {
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max([err[name]] + [r["max_abs_err"] for r in rows]),
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": main["library_ms"],
        }
        if name == "dynslice_fine":  # library_ms: 50 x (band gather + bmm)
            out[name]["library_ms_bmm_only"] = main["bmm_ms"]
    return out


def ptxas_report(log: str, *match: str) -> list[str]:
    """The ptxas lines of a build log (stack and spills, registers) of each
    kernel entry whose name holds one of `match` (every entry if none), as
    "<entry>: <line>"."""
    out, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif (not match or any(m in entry for m in match)) and (
                "spill" in line or "registers" in line):
            out.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return out


TREE_PARTS = ("lk", "bmap", "main", "probes")
# The probe D launches that the "probes" part times, (kernel, B); probe E
# is timed at the probe's r0
TREE_PROBES = (("copy", 16), ("copy", 64), ("copy", 128), ("fine", 16), ("fine", 64),
               ("fine", 128))


def probe_tree_times(kernel_ms):
    """The "probes" part of `tree_run`: device ms per launch of D copy and
    D fine at TREE_PROBES and of E at the probe's r0, beside the library
    calls of the same function (D fine: 50 bmm alone and 50 x (band gather
    + bmm); E: slice + clone); returns a digest of every timed kernel's
    outputs."""
    import torch

    from meshflow_tpu_torch.probes import aligned_dynslice as e, dynslice_fetch as d

    outputs = []
    for kind, b in TREE_PROBES:
        idx, plane = (t.to("cuda") for t in d.probe_inputs(b))
        args = (idx, plane)
        if kind == "fine":
            args += (d.one_hot_rsel(b).to("cuda"),)
        fn = getattr(d, f"dynslice_{kind}")
        outputs += fn(*args)
        kernel_ms[f"D {kind} B={b}"] = device_ms(lambda: fn(*args), launches=20)
        if kind == "fine":
            index = [d.band_index(idx, r, *plane.shape) for r in range(d.REPS)]
            bands = plane[index[-1]]
            kernel_ms[f"D fine B={b} library bmm"] = device_ms(
                lambda: [torch.bmm(args[2], bands) for _ in range(d.REPS)], launches=20)
            kernel_ms[f"D fine B={b} library gather+bmm"] = device_ms(
                lambda: [torch.bmm(args[2], plane[i]) for i in index], launches=20)
    plane, r0 = (t.to("cuda") for t in e.probe_inputs())
    outputs.append(e.aligned_rows(plane, r0))
    kernel_ms["E r0=37"] = device_ms(lambda: e.aligned_rows(plane, r0), launches=20)
    kernel_ms["E library slice+clone"] = device_ms(
        lambda: plane[e.PROBE_ROW : e.PROBE_ROW + e.ROWS].clone(), launches=20)
    return digest(*outputs)


def tree_run(tree: Path, parts=TREE_PARTS, warm_passes: int = 3) -> int:
    """The `parts` of a tree's run, with the package imported from the
    checkout in `tree`; prints one JSON line.  "lk": kernel A on step 3's
    inputs (digest), the device ms per launch of kernel A at every
    `lk_cases` case, of kernel A's set-up alone (``max_iters=0``, "A0") and
    of kernel C at the 8-pair and motion cases, kernel A's launch shape
    (the tree's ``lk_cuda.occupancy()``).  "bmap": kernel B's outputs at
    every BMAP_CASES case (digest), device ms and host-clock ms per call at
    the timed cases.  "main": the 640x360 main path's output digest, crop,
    metrics and wall times.  "probes": `probe_tree_times`.  Always the
    ptxas lines of the tree's LK, backward-map and D and E probe kernels
    (when its build keeps them)."""
    sys.path.insert(0, str(tree))
    import torch

    import meshflow_tpu_torch
    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.kernels import _build, bmap_cuda, lk_cuda

    result = {"package": str(Path(meshflow_tpu_torch.__file__).parent),
              "ptxas": ptxas_report(_build.build()["log"], "lk_", "map_kernel", "table_kernel",
                                   "dynslice", "aligned"),
              "kernel_ms": {}, "host_ms": {}}
    kernel_ms = result["kernel_ms"]
    if "lk" in parts:
        def setup_only(*args, **kwargs):
            return lk_cuda.lk_level(*args, **{**kwargs, "max_iters": 0})

        planes, dims, pts, valid, _ = lk_case("cuda", 8, 90, 160, 2, 6, SEED)
        result["kernel_a"] = digest(*lk_cuda.lk_track_pairs(planes, dims, pts, valid,
                                                            level_fn=lk_cuda.lk_level))
        for name, case in lk_cases("cuda").items():
            kernel_ms[f"A {name}"] = device_ms(lambda: case.track(lk_cuda.lk_level)) / case.levels
            if name in ("8 pairs", "motion"):
                kernel_ms[f"A0 {name}"] = device_ms(lambda: case.track(setup_only)) / case.levels
                with fetch_route("band"):
                    kernel_ms[f"C {name}"] = device_ms(case.track) / case.levels
        result["a_occupancy"] = list(lk_cuda.occupancy())
    if "bmap" in parts:
        outputs = []
        for name in BMAP_CASES:
            config, stab, unstab, h, w = bmap_inputs("cuda", name)
            outputs += list(bmap_cuda.backward_map(stab, unstab, config, h, w))
        result["bmap"] = digest(*outputs)
        for name in BMAP_TIMED:
            kernel_ms[f"B {name}"], result["host_ms"][f"B {name}"] = bmap_times("cuda", name)
    if "probes" in parts:
        result["probes"] = probe_tree_times(kernel_ms)
    if "main" in parts:
        frames = torch.from_numpy(synthetic_clip(300, 360, 640, pan=120)).to("cuda")
        stab = MeshFlowStabilizer(device="cuda")
        seconds = []
        for _ in range(1 + warm_passes):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = stab._stabilize_frames(
                frames, MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
        result.update(main_path=digest(out[0], stab.last_crop), crop=stab.last_crop.tolist(),
                      metrics=[float(x) for x in out[1:]], cold_s=seconds[0],
                      warm_s=seconds[1:])
    print(json.dumps(result))
    return 0


def compare_trees(other: Path, here: Path, parts=TREE_PARTS) -> int:
    """`tree_run` of `other` and of this checkout, each in its own process,
    in the order other, this, this, other; both must give the same bytes."""
    runs = []
    for tree in (other, here, here, other):
        res = subprocess.run(
            [sys.executable, str(here / "chip_smoke.py"), "--tree", str(tree),
             "--parts", ",".join(parts)],
            stdout=subprocess.PIPE, text=True, timeout=900,
        )
        sys.stdout.write(res.stdout)
        check(res.returncode == 0, f"the run of {tree} exited {res.returncode}")
        runs.append(dict(json.loads(res.stdout.strip().splitlines()[-1]), tree=str(tree)))
    for key in ("kernel_a", "bmap", "main_path", "probes"):
        if key in runs[0]:
            check(len({r[key] for r in runs}) == 1, f"the trees' {key} outputs differ")
    warm, times = {}, {"kernel_ms": {}, "host_ms": {}}
    for r in runs:
        warm.setdefault(r["tree"], []).extend(r.get("warm_s", []))
        for kind, per_tree in times.items():
            for name, ms in r[kind].items():
                per_tree.setdefault(r["tree"], {}).setdefault(name, []).append(ms)
    print(json.dumps({"same_outputs": True, "warm_s": warm,
                      "median_warm_s": {t: sorted(v)[len(v) // 2] for t, v in warm.items() if v},
                      "kernel_ms_per_launch": times["kernel_ms"],
                      "host_ms_per_call": times["host_ms"]}))
    return 0


# The keys of an LK kernel's row in the kernels line: `ms`, `plain_ms`,
# `bound_ms` at the main path's motion launch, `ms_8_pairs` at the 8-pair
# case of the earlier kernel table.
LK_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
           "ms_8_pairs")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare", metavar="DIR", type=Path,
                        help="time the checkout in DIR against this one (see above)")
    parser.add_argument("--tree", metavar="DIR", type=Path, help=argparse.SUPPRESS)
    parser.add_argument("--parts", default=",".join(TREE_PARTS),
                        help="with --compare or --tree: the parts to run, of "
                             f"{', '.join(TREE_PARTS)} (default: all)")
    args = parser.parse_args()
    parts = tuple(args.parts.split(","))
    if not set(parts) <= set(TREE_PARTS):
        parser.error(f"--parts: unknown part in {args.parts}")
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "meshflow_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: meshflow_tpu_torch not found beside this script", file=sys.stderr)
        return 2
    if args.tree is not None:
        return tree_run(args.tree.resolve(), parts)
    sys.path.insert(0, str(repo))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    if args.compare is not None:
        return compare_trees(args.compare.resolve(), repo, parts)

    import meshflow_tpu_torch  # noqa: F401  (TF32 pins)
    from meshflow_tpu_torch.kernels import _build

    info = _build.build()
    start = time.perf_counter()
    _build.library_path()
    hash_ms = (time.perf_counter() - start) * 1e3
    print(f"build: {info['seconds']:.2f} s -> {info['path']}; hashing the sources "
          f"{hash_ms:.3f} ms (done once per process, at the first launch)")
    for line in ptxas_report(info["log"]):
        print(f"  ptxas {line}")
    _build.library()

    device = "cuda"
    os.environ.pop("MESHFLOW_LK_FETCH", None)  # the default route, onehot
    cases = lk_cases(device)
    a = phase_kernel_a(device, cases)
    b = phase_kernel_b(device)
    c = phase_kernel_c(device, cases["motion"])
    launches, cold_s, warm_s = phase_main_path(device)
    launches_1080p, first_block = phase_1080p(device)
    phase_1080p_control(device, first_block, pan=360 * (64 - 1) / (300 - 1))
    phase_online(device)
    phase_small_agreement(device)
    probes = phase_probes(device)

    kernels = [
        {"name": "lk_level", "route": "cuda",
         "source": "meshflow_tpu_torch/csrc/lk_level.cu",
         "replaces": "meshflow_tpu/kernels/_lk_pallas_onehot.py:73",
         "launches": launches["lk_level"],
         **{k: a[k] for k in LK_KEYS + ("ms_metric", "ms_online", "warps_per_sm", "regs")}},
        {"name": "backward_map", "route": "cuda",
         "source": "meshflow_tpu_torch/csrc/bmap.cu",
         "replaces": "meshflow_tpu/kernels/bmap_pallas.py:90",
         "launches": launches["backward_map"], **b},
        {"name": "lk_band", "route": "cuda",
         "source": "meshflow_tpu_torch/csrc/lk_band.cu",
         "replaces": "meshflow_tpu/kernels/_lk_pallas_band.py:89",
         "launches": launches_1080p["lk_band"],
         **{k: c[k] for k in LK_KEYS}},
    ] + [
        {"name": name, "route": "cuda",
         "source": f"meshflow_tpu_torch/csrc/{PROBE_KERNELS[name][0]}", **row}
        for name, row in probes.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
