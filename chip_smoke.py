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
4a. the render kernels (``csrc/render.cu``): the warp and the crop-stretch
   against their plain versions, torch.equal to them run on the CPU (and
   the count of bytes that differ from them run on the card), on a
   64-frame 640x360 block, a 64-frame 1920x1080 block (crops of
   ``block_crop``) and one online frame (the fixed online crop); device ms
   a launch and host-clock ms a call beside the bound by bytes and the
   plain version's ms, and each kernel's warps per SM and registers;
5. kernel C (LK level, staged footprint): against the plain version and
   bit for bit against kernel A, at the 640x360 tiles (8 pairs and the
   63-pair motion block) and at 1080p track_downscale=1 tiles (16 of
   270x480, 4 levels, shifts to +-20 px), with the launch shapes of both
   kernels;
5a. kernels A and C on the gray route's planes (C=1): A against its plain
   version at the motion, metric and online launches (16 tiles of
   90x160x1), C bit for bit against A at the motion launch (the 1080p d=3
   gray route's tiles), times beside the plain version and the bound;
6. the main path: ``MeshFlowStabilizer(device="cuda")._stabilize_frames``
   on a synthetic 300-frame 640x360 clip (seeded texture, smooth pan and
   per-frame jitter), cold (peak device memory), warm and a third pass
   with its stages timed, with every kernel's launch count against the
   reckoned one;
7. the 1080p path: a 300-frame 1920x1080 clip at the automatic track
   geometry (d=3) with MESHFLOW_LK_FETCH=band, as step 6, kernel C in
   kernel A's place;
8. the 1080p track_downscale=1 control beside d=3 on the clip's first 64
   frames: wall time and the three metrics of each;
9. online mode: ``OnlineMeshFlowStabilizer(device="cuda").process`` over
   a 120-frame 640x360 clip, per-frame latency, launch counts, and a
   stabilized path smoother than the raw one;
10. the main path on a small clip on the card and on the CPU (plain
   versions), whose outputs must agree;
11. native_io: whether ``native/libmeshflow_videoio.so`` (libav decode and
   encode) loads on the machine, and the loader's reason when it does not;
12. streamed: the stream (``MeshFlowStabilizer._stream``) on the
   300-frame 640x360 clip through an array-backed clip and a capturing
   writer (no codec),
   at CHUNK 64 and 16, its frames torch.equal and its metrics equal to
   ``_stabilize_frames`` at the same CHUNK, the kernels' launch counts,
   warm wall time and a pass with its stages timed;
12a. graphs: every phase runs its match batches (and online its step) as
   CUDA graphs of its stabilizer's runner (``utils/graphs.py``); this
   phase runs the 640x360 main path, online over the clip's first 40
   frames, the 1080p d=3 path (kernel C) and the stream at CHUNK 64 on the
   card eagerly (``_graphs=False``) beside the graphed stabilizers of the
   phases above: crop, frames and metrics torch.equal, launch counters
   equal (eig9's too), no capture in a warm graphed pass; warm passes of
   the two routes alternating; for each route warm walls, stages, and on
   the first 64 frames the card's busy share and CUDA launches and kernels
   by stage (profiler traces through MESHFLOW_TRACE_DIR) with the hand
   kernels the card ran counted by name and equal to the wrappers' counts
   (also over 8 replayed online frames), peak device memory, online p50 /
   p90 and first frames; the graphed route's capture seconds and pool.
   The 4K and 1080p/64 phases add an eager cold pass for its peak memory,
   and close their stabilizers at their end (freeing the graphs' pool);
12b. eig9: the eig9 kernel (the DLT's null vector) against eigh and
   against its PyTorch emulation on the DLT inputs of one motion block and
   one metric block of the 640x360 clip, recorded on the eager route:
   homographies within 1e-5 relative where eigh's eigenvalue gap exceeds
   1e-9 ||N||_F, Rayleigh quotients within 1e-12 ||N||_F of the least
   eigenvalue, equal ok and degenerate masks downstream; its time beside
   eigh's, both by device events and by the host clock, and its bound
   from what the function needs; whether the 640x360 digest moved;
13. checkpoint: a streamed run that writes a checkpoint under a temporary
   directory, then reruns under the same and another variant that skip
   pass 1 (kernel A runs the metric pass's launches only) and equal fresh
   runs;
14. memory: peak device memory at 1920x1080 x 300 frames (d=3, kernel C),
   the in-memory route against the stream with
   MESHFLOW_HBM_FRAME_BUDGET_GB=0 (pass 1 and the rest apart), equal
   outputs;
15. file: when the native library loads, the clip written by the native
   encoder, ``stabilize(in, out, 0)`` file to file on the card, the
   output's frame count, fps and size, decode and encode seconds;
   otherwise the line says why it was skipped;
15a. gray: the gray-plane route (track_planes="gray") on the 640x360 clip
   in memory, cold and warm beside BGR, kernel A and B launches as
   reckoned (one map a block serves the BGR render and the gray metric
   re-render); streamed at CHUNK 64, torch.equal to it; the 1080p clip at
   d=3 with kernel C, warm wall and peak device memory beside BGR's;
   online mode over 120 frames, p50 and p90 beside BGR's;
15b. sharded: kernel A at the path's launches (a 4-shard block's 75-pair
   motion and 75-frame metric launches and the 1-shard block's 300
   pairs; the plain version timed at the motion launch) against its plain
   version, kernel B at its 75- and 300-frame launches equal to its plain
   version (all in this process), then ``parallel.stabilize_sharded`` on
   the 640x360 clip with its shards on ["cuda:0"] (this process) and
   ["cuda:0"] * 4 (four worker processes, a gloo group): crop equal,
   metrics within 1e-3, frames within 1 LSB on > 99.9% of pixels, the halo
   solve torch.equal to the replicated one, serving mode, launches summed
   over the processes, cold and warm walls, each worker's peak device
   memory, the CPU seconds of this process and of each worker with their
   busiest threads (``cpu_use``), the card's memory in use with the
   workers idle, and the clip's host round trip;
15c. batch: ``parallel.stabilize_batch`` on two 640x360 x 120-frame clips
   (array-backed in, capturing writer out) on one worker (this process)
   and on two worker processes of the card, cold and warm, each job equal
   to a solo ``stabilize``, launches summed over the processes, walls and
   each worker's CPU seconds, the CPU seconds of every process by thread,
   the card's busy share as nvidia-smi samples it; one worker once more
   with the card's kernels traced;
15d. geometry kernels: kernel A against its plain version at the 4K
   motion and metric launches (63 pairs and 64 frames of 16 tiles of
   108x192x3, 3 levels: a 3840x2160 clip tracks at 768x432) and at the
   sharded 4K launches of one shard (15 pairs and 16 frames of 16 tiles of
   540x960x3, 4 levels: the sharded path tracks at full size), kernel C
   bit for bit against A at the 4K motion launch; kernel B equal to its
   plain version on every frame of a 64-frame 4K block and of a 64-frame
   1080p block on the 64x64 mesh (its global-table route), device ms
   beside the plain version's over the block and the bound;
15e. 4K: a 3840x2160 x 300-frame clip (d=5, kernel A) in memory, cold
   (peak device memory), warm and a pass with its stages timed, launches
   against the reckoned counts (A 30, B 5); serving mode on the same
   frames (frames torch.equal, area scores NaN, A 15); streamed with the
   default budgets (a resident prefix, the rest of pass 2 from the host
   cache) and with MESHFLOW_HOST_FRAME_CACHE_GB=0 (the rest decoded from
   the clip again), each torch.equal to in memory with equal metrics, with
   the branch that served each pass-2 block, peak device memory and the
   process's peak RSS (about 35 GB of host RAM);
15f. 1080p/64: 1920x1080 x 300 frames on the 64x64 mesh (d=3, kernel A) in
   memory and streamed, torch.equal; its motion stage beside the 16x16
   mesh's;
15g. 720p: 1280x720 x 300 frames (d=2) in memory and streamed, torch.equal;
15h. serving at 640x360: compute_metrics=False against the main path's
   cold pass, frames torch.equal, area scores NaN, kernel A 15 launches;
15i. sharded 4K: ``parallel.stabilize_sharded`` on 3840x2160 x 16 frames
   over 1 and 2 logical shards of the card (this process; two worker
   processes, cold and warm) within the shard-count gates of step 15b,
   with the peak device memory of each process, the CPU seconds of every
   process by thread and the card's busy share as nvidia-smi samples it
   (one shard also traced); the 2-process call taken apart
   (``sharded_stages``: this process's copies, rank 0's stages with the
   card synchronized between them, then rank 0's kernels traced while
   rank 1 runs untraced), torch.equal to the plain call; the halo Jacobi
   alone over 3600 frames of seeded displacement fields of the default
   mesh on 4 logical shards, four worker processes, torch.equal to the
   replicated solve;
16. the probes: ``python -m meshflow_tpu_torch.probes`` with the six
   probe kernels' launch counts set to 0 before it (probe F also on
   general float32 values), then each probe kernel against its plain
   version, bit for bit (probe D's copy and one-hot at 4 to 128 features,
   1 to RING + 1 and 50 rounds, one-hot rows inside, past and before the
   plane; its fine select with a one-hot and a random selection at 4 to
   128 features and 1 to 50 rounds; probe E at every start of its plane
   and at widths 4 to 1024; probe G at 1, 8 and 32 features, clamped and
   wrapped bases, launched with and without programmatic dependent
   launch, beside the launch floor of its grid and one index_select of
   its rows); and each D kernel's marginal round at B = 16,
   (t50 - t1) / 49, gated at no less than the round's bytes over the
   card's aggregate shared-memory rate, so that no round is skipped.

Each kernel's bound is the larger of its operations over the H100's
float32 rate and its bytes over its memory rate; for the LK kernels the
plain version counts the iterations the inputs need, for kernel B the
lookups, homographies and bbox tests its pixels need (``return_work``).  Times, bounds and launches are per
kernel launch (an LK track of 3 levels is 3 launches; kernel B's entry
point is one launch of its table kernel and one of its map kernel); an LK
kernel's `ms` is at the main path's motion launch, `ms_8_pairs` at the
8-pair case; kernel B's at the main path's launch, beside `host_ms`,
`ms_online`, `host_ms_online` and `ms_1080p_mesh64`; `launches_streamed`
counts a kernel's launches in the streamed 640x360 run (kernel C's in
the streamed 1080p run); `launches_gray`, `launches_gray_online`,
`launches_gray_1080p`, `launches_sharded` (4 shards) and `launches_batch`
(2 workers) in those paths' runs (on the parallel paths, summed over the
worker processes); `*_gray` are A's and C's numbers at C=1
(step 5a), `*_sharded` A's and B's at a 4-shard block's launches and
`*_sharded_1_shard` at the 1-shard block's (step 15b); `*_4k` A's, C's and
B's numbers at the 4K motion and render launches, A's `*_4k_metric` at
the 4K metric launch and `*_sharded_4k` and `*_sharded_4k_metric` at the
sharded 4K launches, and B's `*_1080p_mesh64_block` at the 64-frame block
on the 64x64 mesh (step 15d); `launches_4k`,
`launches_4k_streamed`, `launches_4k_serving`, `launches_serving`
(640x360), `launches_mesh64`, `launches_mesh64_streamed`, `launches_720p`
and `launches_sharded_4k` (2 shards) in those runs.  Prints one JSON
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
the parts named (``batch``, two clips on two worker processes, and
``sharded``, the 4K sharded call and the halo Jacobi over worker
processes, run only when named); ``probes`` times probe D's
copy and fine select at 16,
64 and 128 features, its one-hot select at 16 (all three at 16 also at
one round a launch), probe E at the probe's r0 and probe G at B = 8 (with
and without programmatic dependent launch, and its launch floor, where
the tree has them), beside the PyTorch calls of the same functions.

    python3 chip_smoke.py --tree DIR --parts main,online,batch,sharded

runs the named parts of the checkout in DIR alone and prints their JSON
line, with no comparison: for trees whose outputs differ (``online``:
the 120-frame online run; in a tree whose stabilizers take ``_graphs``,
``main`` and ``online`` also run the card eagerly).  Run it for each
tree in turn, in the order DIR, this, this, DIR, in one call.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import inspect
import json
import os
import re
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


class env_set:
    """Environment variables set to `values` inside the block only."""

    def __init__(self, **values):
        self.values, self.saved = values, {}

    def __enter__(self):
        for name, value in self.values.items():
            self.saved[name] = os.environ.get(name)
            os.environ[name] = value

    def __exit__(self, *exc):
        for name, value in self.saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def fetch_route(route):
    """MESHFLOW_LK_FETCH set to `route` inside the block only."""
    return env_set(MESHFLOW_LK_FETCH=route)


def reset_launches():
    from meshflow_tpu_torch.kernels import bmap_cuda, eig9_cuda, lk_band_cuda, lk_cuda

    lk_cuda.lk_level.launches = 0
    lk_band_cuda.lk_level_band.launches = 0
    bmap_cuda.backward_map.launches = 0
    eig9_cuda.null_vector.launches = 0


def eig9_launches() -> int:
    """The eig9 kernel's launches since ``reset_launches``."""
    from meshflow_tpu_torch.kernels import eig9_cuda

    return eig9_cuda.null_vector.launches


def eig9_count(config, num_frames, chunk, streamed=False):
    """eig9 launches of a pass: four a match batch (RANSAC's fit and its
    polish rounds, then the global fit), batches of PAIR_BATCH pairs over
    each motion block (a streamed window: its pairs with the halo frame)
    and, with metrics on, each metric block."""
    import math

    from meshflow_tpu_torch.motion.pipeline import PAIR_BATCH

    per = 2 + config.ransac_polish_rounds
    if streamed:
        pairs = [min(chunk, num_frames) - 1] + [
            min(chunk, num_frames - s) for s in range(chunk, num_frames, chunk)]
    else:
        pairs = [min(chunk - 1, num_frames - 1 - s) for s in range(0, num_frames - 1, chunk - 1)]
    batches = sum(math.ceil(p / PAIR_BATCH) for p in pairs)
    if config.compute_metrics:
        batches += sum(math.ceil(min(chunk, num_frames - s) / PAIR_BATCH)
                       for s in range(0, num_frames, chunk))
    return per * batches


def runner_state(stab):
    """(captures, replays, capture seconds) of a stabilizer's graph runner."""
    r = stab._runner
    return r.captures, r.replays, r.capture_seconds


def release_graphs(name, stab):
    """Close a stabilizer at the end of a geometry's phase, as a user done
    with that geometry would: print its graphs' pool and the card memory
    its ``close()`` returned."""
    import torch

    held = pool_gib(stab)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    stab.close()
    print(f"{name}: the stabilizer's close() freed its graphs' pool of {held} GiB: "
          f"{(torch.cuda.mem_get_info()[0] - free) / (1 << 30):.3f} GiB of the card back")


def pool_gib(stab):
    """GiB a stabilizer's graph pool holds (None: not readable)."""
    held = stab._runner.pool_bytes()
    return None if held is None else held / (1 << 30)


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


def lk_case(device, pairs, th, tw, max_level, max_shift, seed, channels=3):
    """Seeded textured tiles with known integer shifts: 16 tiles of
    `channels` planes (3: BGR, 1: the gray route's), 512 slots; returns
    (planes, dims, pts, valid, shifts).  The canvas and its margin are
    those of kernel A's first check, so that check's inputs stay the
    same."""
    import numpy as np
    import torch

    from meshflow_tpu_torch.kernels.lk import reflect_pad_level
    from meshflow_tpu_torch.kernels.pyramid import build_pyramid, pyramid_shapes

    rng = np.random.default_rng(seed)
    s, c, k = 16, channels, 512
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
                 max_shift=6, seed=SEED, channels=3):
        self.name, self.shifted, self.levels = name, shifted, max_level + 1
        self.shape = (f"{pairs} pairs, 16 tiles {th}x{tw}x{channels}, K 512, {self.levels} "
                      "levels" + ("" if shifted else ", shifted=False, init_pts"))
        (self.planes, self.dims, self.pts, self.valid,
         self.shifts) = lk_case(device, pairs, th, tw, max_level, max_shift, seed, channels)
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


def kernel_a_row(label, case, plain_batches):
    """Kernel A against its plain version on `case`: A's gates, then device
    ms per launch beside the plain version's (`plain_batches` batches of
    one track; 0: not timed) and the bound.  Returns (row, max endpoint
    distance)."""
    from meshflow_tpu_torch.kernels import lk_cuda

    kp, kst = case.track(lk_cuda.lk_level)
    pp, pst, bound_ms, bound_by, stats = lk_plain(case)
    _, _, max_err, _ = lk_gates(label, kp, kst, pp, pst, case.pts, case.valid, case.shifts)
    ms = device_ms(lambda: case.track(lk_cuda.lk_level)) / case.levels
    plain_ms = None
    if plain_batches:
        plain_ms = device_ms(lambda: case.track(lk_cuda.lk_level_plain), launches=1,
                             batches=plain_batches) / case.levels
    plain = "not timed" if plain_ms is None else f"{plain_ms:.4f} ms"
    print(f"{label} per launch ({case.shape}): kernel {ms:.4f} ms, plain {plain}, bound "
          f"{bound_ms:.4f} ms ({bound_by}); per launch {stats['setups']:.0f} set-ups, "
          f"{stats['iters']:.0f} steps")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            **stats}, max_err


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
        big = name in ("motion", "metric")
        out[name], max_err = kernel_a_row(f"kernel A {name}", case, 1 if big else 3)
        out["max_abs_err"] = max(out["max_abs_err"], max_err)
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


def gray_lk_cases(device):
    """Kernel A's main-path cases on the gray route's planes (C=1): the
    motion launch (63 pairs), the metric launch (64 frames, shifted=False)
    and the online launch (1 pair), 16 tiles of 90x160x1, K 512, 3 levels."""
    return {
        "motion": LkCase(device, "gray motion", 63, seed=SEED + 12, channels=1),
        "metric": LkCase(device, "gray metric", 64, shifted=False, seed=SEED + 13, channels=1),
        "online": LkCase(device, "gray online", 1, seed=SEED + 14, channels=1),
    }


def phase_gray_kernels(device):
    """Kernels A and C on the gray route's planes (C=1) on the card: A
    against its plain version at the motion, metric and online launches
    (A's gates), device ms per launch beside the plain version's and the
    bound; C at the motion launch (the 1080p d=3 gray route's tiles) bit
    for bit against A, its ms beside A's; both launch shapes at C=1."""
    import torch

    from meshflow_tpu_torch.kernels import lk_band_cuda, lk_cuda
    from meshflow_tpu_torch.kernels.lk import PAD

    cases = gray_lk_cases(device)
    out = {"max_abs_err": 0.0, "occupancy": lk_cuda.occupancy(1)}
    for name, case in cases.items():
        out[name], max_err = kernel_a_row(f"kernel A C=1 {name}", case,
                                          1 if name != "online" else 3)
        out["max_abs_err"] = max(out["max_abs_err"], max_err)

    case = cases["motion"]

    def band():
        with fetch_route("band"):
            return case.track()

    before = lk_band_cuda.lk_level_band.launches
    cp, cst = band()
    check(lk_band_cuda.lk_level_band.launches == before + case.levels,
          "kernel C launch count of one C=1 track")
    ap, ast = case.track(lk_cuda.lk_level)
    pp, pst, bound_ms, bound_by, _ = lk_plain(case)
    _, _, max_err, _ = lk_gates("kernel C C=1 motion", cp, cst, pp, pst, case.pts, case.valid,
                                case.shifts)
    same_as_a = bool(torch.equal(cp, ap)) and bool(torch.equal(cst, ast))
    check(same_as_a, "kernel C differs from kernel A at C=1")
    ms = device_ms(band) / case.levels
    dims = case.dims
    top, low = (
        lk_band_cuda.occupancy(1, patch, dims[lvl][0] + 2 * PAD, dims[lvl][1] + 2 * PAD)
        for patch, lvl in ((lk_band_cuda.PN_TOP, case.levels - 1), (lk_band_cuda.PN_LOWER, 0))
    )
    out["band"] = {"ms": ms, "plain_ms": out["motion"]["plain_ms"], "bound_ms": bound_ms,
                   "bound_by": bound_by, "max_abs_err": max_err}
    print(f"kernel C C=1 motion per launch ({case.shape}): corners and status bit-identical "
          f"to kernel A; kernel C {ms:.4f} ms, kernel A {out['motion']['ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}); (warps/SM, shared B/block, warps/block, "
          f"registers): A at C=1 {out['occupancy']}, C top {top}, C lower {low}")
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


def bmap_inputs(device, name, cases=BMAP_CASES):
    """(config, stab_pos, unstab_grid, h, w) of kernel B's case `name` of
    `cases`, seeded."""
    import numpy as np
    import torch

    from meshflow_tpu_torch.config import MeshFlowConfig
    from meshflow_tpu_torch.utils import grid

    w, h, mesh, sigma, frames, degenerate = cases[name]
    config = MeshFlowConfig(mesh_row_count=mesh, mesh_col_count=mesh)
    rng = np.random.default_rng(SEED + mesh + int(sigma))
    unstab = grid.vertex_grid(config, h, w, device=device)
    shape = (frames,) + tuple(unstab.shape) if frames > 1 else tuple(unstab.shape)
    stab = unstab + torch.from_numpy(rng.normal(0.0, sigma, shape).astype(np.float32)).to(device)
    return config, degenerate_quads(stab) if degenerate else stab, unstab, h, w


def bmap_bound(config, stab, unstab, work):
    """(bound_ms, bound_by, bound_ms if every pixel took every step and all
    9 candidates) of one backward_map call, from the work its data needs
    (``backward_map_plain(..., return_work=True)``)."""
    return bmap_bound_of(config, stab, unstab, {k: int(v.sum()) for k, v in work.items()},
                         work["lookups"].numel())


def bmap_bound_of(config, stab, unstab, count, pixels):
    """`bmap_bound` from the work's totals `count` over `pixels` pixels."""
    frames = stab.shape[0] if stab.dim() == 4 else 1
    cells = config.mesh_row_count * config.mesh_col_count
    ops = (BMAP_LOOKUP_OPS * count["lookups"] + BMAP_HOMOGRAPHY_OPS * count["homographies"]
           + BMAP_BBOX_OPS * count["candidates"] + BMAP_CELL_OPS * frames * cells)
    nbytes = (stab.numel() + unstab.numel()) * 4 + 9 * pixels
    full, _ = bound((4 * BMAP_LOOKUP_OPS + 12 * BMAP_HOMOGRAPHY_OPS + 9 * BMAP_BBOX_OPS)
                    * pixels + BMAP_CELL_OPS * frames * cells, nbytes)
    return bound(ops, nbytes) + (full,)


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
            out["bound_ms"], out["bound_by"], full = bmap_bound(config, stab, unstab, work)
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


# The render kernels' cases: (W, H, mesh, vertex jitter px, frames, _) as
# BMAP_CASES, the maps from kernel B.
RENDER_CASES = {
    "640x360 block": (640, 360, 16, 3.0, 64, False),
    "1080p block": (1920, 1080, 16, 6.0, 64, False),
    "online": (640, 360, 16, 3.0, 1, False),
}


def phase_render_kernels(device, cases=RENDER_CASES):
    """The warp and crop-stretch kernels against their plain versions on the
    card at each case of `cases`: torch.equal to the plain version run on
    the CPU (the gate; the crop scales by IEEE division as the CPU does),
    the bytes that differ from the plain version run on the card, device ms
    a launch, host-clock ms a call, the bound by bytes (the warp reads 9 B
    of map and C B of frame and writes C B a pixel, the crop reads and
    writes C B) and the plain version's device ms; each kernel's launch
    shape at C = 3 and 1.  Returns {case: {"warp": row, "crop": row},
    "shape": ...}."""
    import ctypes

    import numpy as np
    import torch

    from meshflow_tpu_torch import online
    from meshflow_tpu_torch.kernels import _build, bmap_cuda, render_cuda
    from meshflow_tpu_torch.render.stabilize import BackwardMap, block_crop, border_color

    shape = {}
    for crop in (0, 1):
        for c in (3, 1):
            vals = [ctypes.c_int() for _ in range(2)]
            _build.check(_build.library().meshflow_render_occupancy(
                crop, c, *map(ctypes.byref, vals)), "render occupancy")
            name = f"{'crop' if crop else 'warp'} C={c}"
            shape[name] = {"warps_per_sm": vals[0].value, "regs": vals[1].value}
            print(f"render {name}: {vals[0].value} warps/SM, {vals[1].value} registers/thread")
    out = {"shape": shape}
    for name in cases:
        config, stab, unstab, h, w = bmap_inputs(device, name, cases)
        bmap = bmap_cuda.backward_map(stab, unstab, config, h, w)
        rng = np.random.default_rng(SEED + h)
        f = stab.shape[0] if stab.dim() == 4 else 1
        frames = torch.from_numpy(
            rng.integers(0, 256, (f, h, w, 3)[f == 1:], dtype=np.uint8)).to(device)
        crop = (online.online_constants(config, h, w, 0.8, device).crop if f == 1
                else block_crop(bmap, h, w))
        border = border_color(config, 3)
        warped = render_cuda.warp(frames, bmap, border)
        cropped = render_cuda.crop_resize(warped, crop, h, w)
        cpu_map = BackwardMap(*(m.cpu() for m in bmap))
        want = render_cuda.warp_plain(frames.cpu(), cpu_map, border)
        rows = {}
        for kernel, got, plain_cpu, plain_card, call, plain_call, per_pixel in (
            ("warp", warped, lambda: want,
             lambda: render_cuda.warp_plain(frames, bmap, border),
             lambda: render_cuda.warp(frames, bmap, border),
             lambda: render_cuda.warp_plain(frames, bmap, border), 9 + 2 * 3),
            ("crop", cropped, lambda: render_cuda.crop_resize_plain(want, crop.cpu(), h, w),
             lambda: render_cuda.crop_resize_plain(warped, crop, h, w),
             lambda: render_cuda.crop_resize(warped, crop, h, w),
             lambda: render_cuda.crop_resize_plain(warped, crop, h, w), 2 * 3),
        ):
            equal = bool(torch.equal(got.cpu(), plain_cpu()))
            differ_card = int((got != plain_card()).sum())
            bound_ms, bound_by = bound(0, f * h * w * per_pixel)
            row = {"equal_plain_cpu": equal, "bytes_differing_plain_card": differ_card,
                   "ms": device_ms(call), "host_ms": host_clock_ms(call),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "plain_ms": device_ms(plain_call, launches=1, batches=3)}
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            print(f"render {kernel} {name} ({w}x{h}, {f} frame(s), crop {crop.tolist()}): equal to "
                  f"the plain version on the CPU {equal}, {differ_card} bytes differ from it on "
                  f"the card; kernel {row['ms']:.4f} ms (host clock {row['host_ms']:.4f} ms), "
                  f"bound {bound_ms:.4f} ms ({bound_by}, {100 * row['share_of_bound']:.1f}%), "
                  f"plain {row['plain_ms']:.4f} ms")
            check(equal, f"render {kernel} differs from its plain version ({name})")
            rows[kernel] = row
        check(not bool(cpu_map.covered.all()), f"render {name}: no uncovered pixel")
        out[name] = rows
        del frames, warped, cropped, want, bmap, cpu_map
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
    """The port's main path on a 300-frame 640x360 clip (``in_memory_passes``
    at the default config, kernel A); returns (launches, cold s, warm s, the
    cold pass's output)."""
    from meshflow_tpu_torch.config import MeshFlowConfig

    run = in_memory_passes("main path", device, synthetic_clip(num_frames, h, w, pan=pan),
                           MeshFlowConfig(), pan)
    return run["launches"], run["cold_s"], run["warm_s"], run["out"], run


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


def in_memory_passes(name, device, frames_np, config, pan, route=None, eager_peak=False):
    """``_stabilize_frames`` on `frames_np` with `config`, on kernel A (the
    default route) or, with route="band", on kernel C, its match batches as
    CUDA graphs of the stabilizer's runner: a cold pass with its peak device
    memory above the start (the clip's upload included), a warm pass equal
    to it, a third pass with its stages timed; the cold pass's launches
    against the reckoned counts (eig9's too) and the output checks; at most
    one capture a batch kind in the cold pass and none in the warm one.
    With eager_peak, one more cold pass on the card run eagerly
    (``_graphs=False``)
    for its peak device memory with a second copy of the clip uploaded
    inside its window, as in the cold pass, torch.equal to the graphed one.
    Returns a dict with the stabilizer, the frames and the cold pass's
    output on the device."""
    import contextlib

    import torch

    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.utils.profiling import StageTimer

    num_frames, h, w = frames_np.shape[:3]
    stab = MeshFlowStabilizer(config=config, device=device)
    with fetch_route(route) if route else contextlib.nullcontext():
        graphs_before = runner_state(stab)
        with peak_memory() as peak:
            frames = torch.from_numpy(frames_np).to(device)
            reset_launches()
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = stab._stabilize_frames(frames, 0)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - start
        launches, eig9 = read_launches(), eig9_launches()
        graphs_cold = runner_state(stab)
        start = time.perf_counter()
        warm = stab._stabilize_frames(frames, 0)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - start
        graphs_warm = runner_state(stab)
        check(torch.equal(out[0], warm[0]), f"{name}: warm pass output differs from cold pass")
        del warm
        # a third pass for the stages: the timer synchronizes at each stage end
        stab._stabilize_frames(frames, 0, StageTimer(enabled=True, device=device))
        if eager_peak:
            with peak_memory() as eager:  # the clip's upload inside, as in the cold pass
                frames_e = torch.from_numpy(frames_np).to(device)
                start = time.perf_counter()
                got = MeshFlowStabilizer(config=config, device=device,
                                         _graphs=False)._stabilize_frames(frames_e, 0)
                torch.cuda.synchronize()
                eager_s = time.perf_counter() - start
            del frames_e
            check(all(torch.equal(a, b) for a, b in zip(got, out)),
                  f"{name}: the eager pass differs from the graphed one")
            del got
    stages = stage_seconds(stab.last_timer)
    crop, metrics, mean_dx = check_output(name, stab, out, num_frames, h, w, pan, device)
    lk, bmap = stream_launch_counts(config, h, w, num_frames, stab.CHUNK)
    kernel, key = ("C", "lk_band") if route == "band" else ("A", "lk_level")
    check(launches == {"lk_level": 0, "lk_band": 0, key: lk, "backward_map": bmap},
          f"{name}: launches {launches}, expected kernel {kernel} {lk}, kernel B {bmap}")
    want_eig9 = eig9_count(config, num_frames, stab.CHUNK)
    check(eig9 == want_eig9, f"{name}: eig9 ran {eig9} times, reckoned {want_eig9}")
    captures = graphs_cold[0] - graphs_before[0]
    check(captures <= 1 + config.compute_metrics and graphs_warm[0] == graphs_cold[0],
          f"{name}: {captures} captures in the cold pass, "
          f"{graphs_warm[0] - graphs_cold[0]} in the warm one")
    th, tw = config.track_shape(h, w)
    graph_note = (f"graphs: {captures} captured in the cold pass "
                  f"({graphs_cold[2] - graphs_before[2]:.3f} s), "
                  f"{graphs_warm[1] - graphs_cold[1]} replays and no capture in the warm pass, "
                  f"pool {pool_gib(stab)} GiB")
    print(f"{name}: {num_frames} frames {w}x{h}, mesh {config.mesh_row_count}x"
          f"{config.mesh_col_count}, d={config.resolve_track_downscale(h, w)} (tracking "
          f"{tw}x{th}), kernel {kernel}: cold {cold_s:.3f} s, warm {warm_s:.3f} s "
          f"({num_frames / warm_s:.2f} fps); peak device memory {peak.gib:.3f} GiB; launches "
          f"{launches} (reckoned: kernel {kernel} {lk}, kernel B {bmap}), eig9 {eig9}; "
          f"{graph_note}; crop {crop}; "
          f"cropping ratio {metrics[0]:.6f}, distortion {metrics[1]:.6f}, stability "
          f"{metrics[2]:.6f}; last-frame mean x displacement {mean_dx:.3f} px; third pass "
          f"stages (s) {stages}")
    run = {"stab": stab, "frames": frames, "out": out, "cold_s": cold_s, "warm_s": warm_s,
           "stages": stages, "peak_gib": peak.gib, "launches": launches, "crop": crop,
           "metrics": metrics, "eig9": eig9, "captures": captures,
           "capture_s": graphs_cold[2] - graphs_before[2], "pool_gib": pool_gib(stab)}
    if eager_peak:
        run.update(eager_peak_gib=eager.gib, eager_cold_s=eager_s)
        print(f"{name} eager (_graphs=False): cold {eager_s:.3f} s, peak device memory "
              f"{eager.gib:.3f} GiB beside the graphed cold pass's {peak.gib:.3f} (both with "
              f"the clip's upload); outputs torch.equal")
    return run


def phase_1080p(device, num_frames=300, h=1080, w=1920, pan=360):
    """The 1080p path, automatic track geometry (d=3: tracking at 640x360),
    with kernel C (MESHFLOW_LK_FETCH=band for this phase only):
    ``in_memory_passes``.  Returns (launches, the clip's first 64 frames on
    the device, warm s, the third pass's stages)."""
    from meshflow_tpu_torch.config import MeshFlowConfig

    run = in_memory_passes("1080p path", device, synthetic_clip(num_frames, h, w, pan=pan),
                           MeshFlowConfig(), pan, route="band")
    return run["launches"], run["frames"][:64], run["warm_s"], run["stages"], run


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


def phase_online(device, num_frames=120, h=360, w=640, config=None, name="online",
                 graphed=True, frames=None):
    """Online mode on a jittery 640x360 clip with the default fetch (and
    `config`, default the default one), its step one CUDA graph of the
    stabilizer's own, captured at the third frame and replayed after
    (graphed=False runs it eagerly); the graph released at the end.
    `frames`: the clip's frames (default the synthetic 640x360 clip of
    `num_frames`)."""
    import numpy as np
    import torch

    from meshflow_tpu_torch.online import OnlineMeshFlowStabilizer

    if frames is None:
        frames = synthetic_clip(num_frames, h, w, pan=60)
    num_frames = len(frames)
    stab = OnlineMeshFlowStabilizer(config=config, device=device, _graphs=graphed)
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
    eig9 = eig9_launches()
    graph_runs = (stab._runner.captures, stab._runner.replays)
    stab.close()
    steady = np.asarray(times[10:])
    c_jerk = np.abs(np.diff(np.asarray(c_mean[1:]), 2, axis=0)).mean()
    p_jerk = np.abs(np.diff(np.asarray(p_mean[1:]), 2, axis=0)).mean()
    p50, p90 = np.percentile(steady, 50), np.percentile(steady, 90)
    print(f"{name}: {num_frames} frames {w}x{h}: first frame {times[0]:.3f} ms, per-frame "
          f"p50 {p50:.3f} ms p90 {p90:.3f} ms (frames 10-{num_frames - 1}); launches "
          f"{launches}, eig9 {eig9}; graph captures and replays {graph_runs}; mean |second "
          f"difference| of the frame-mean path: raw c_t {c_jerk:.4f} px, stabilized p_t "
          f"{p_jerk:.4f} px")
    check(np.array_equal(outs[0], frames[0]), f"{name}: first output differs from first input")
    check(all(o.shape == (h, w, 3) and o.dtype == np.uint8 for o in outs),
          f"{name}: output shape or dtype")
    check(launches["lk_level"] == levels * (num_frames - 1) and launches["lk_band"] == 0,
          f"{name}: kernel A ran {launches['lk_level']} times, expected {levels} x "
          f"{num_frames - 1}")
    check(launches["backward_map"] == num_frames - 1, f"{name}: kernel B launch count")
    check(p_jerk < c_jerk, f"{name}: stabilized path {p_jerk} not smoother than {c_jerk}")
    check(eig9 == 4 * (num_frames - 1), f"{name}: eig9 ran {eig9} times, expected 4 x "
          f"{num_frames - 1}")
    if stab._runner.enabled:
        check(graph_runs == (1, num_frames - 2),
              f"{name}: {graph_runs} captures and replays, expected 1 and {num_frames - 2}")
    return {"first_ms": times[0], "p50_ms": p50, "p90_ms": p90, "launches": launches,
            "eig9": eig9, "second_ms": times[1], "third_ms": times[2], "outs": outs,
            "frames": frames}


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


def phase_native_io():
    """Whether the committed native libav library loads on this machine,
    and why not when it does not; nothing is installed either way."""
    from meshflow_tpu_torch.io import native

    ok = native.available()
    where = native.LIB_PATH.relative_to(Path(__file__).resolve().parent)
    print(f"native_io: {where} loads: {ok}"
          + ("" if ok else f" ({native.load_error()}); nothing is installed"))
    return ok


def stage_seconds(timer) -> dict:
    """{stage: seconds} of a stage timer, each stage's runs summed."""
    out = {}
    for name, sec in timer.stages:
        out[name] = out.get(name, 0.0) + sec
    return {name: round(sec, 4) for name, sec in out.items()}


def stream_launch_counts(config, h, w, num_frames, chunk):
    """(LK launches, backward-map calls) of a clip through the pipeline,
    from either driver: pass 1's windows and pass 2's metric blocks at the
    LK's levels, and two maps a block (the crop scan, then pass 2)."""
    import math

    levels = config.lk_max_level(*config.track_shape(h, w)) + 1
    blocks = math.ceil((num_frames - 1) / (chunk - 1)), math.ceil(num_frames / chunk)
    lk = levels * (blocks[0] + (blocks[1] if config.compute_metrics else 0))
    return lk, 2 * blocks[1]


def run_streamed(stab, clip, device, variant=0, timer=None, checkpoint_dir=None):
    """One streamed run of `clip` into a capturing writer, its match
    batches through the stabilizer's runner, as ``stab.stabilize`` runs
    it: (frames on the host, metrics, seconds, launches)."""
    import torch

    from meshflow_tpu_torch import streaming
    from meshflow_tpu_torch.utils.profiling import StageTimer

    writer = streaming.CaptureWriter()
    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    stab.checkpoint_dir = checkpoint_dir
    metrics = stab._stream(clip, writer, variant,
                           timer or StageTimer(enabled=False, device=device))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    return writer.frames(), metrics, seconds, read_launches()


def in_memory(stab, frames_np, device, variant=0):
    """The in-memory route on host frames: (cropped frames on the host,
    metrics, launches)."""
    import torch

    reset_launches()
    out = stab._stabilize_frames(torch.from_numpy(frames_np).to(device), variant)
    launches = read_launches()
    return out[0].cpu(), tuple(float(x) for x in out[1:]), launches


class peak_memory:
    """Peak device memory allocated inside the block above what was
    allocated at its start (``bytes`` and ``gib`` after the block)."""

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        self.base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.bytes = torch.cuda.max_memory_allocated() - self.base
        self.gib = self.bytes / (1 << 30)


def peak_in_memory(stab, frames_np, device):
    """The in-memory route on host frames (``in_memory``) and its peak
    device memory above what was held before, as ``phase_memory`` takes
    it: (cropped frames on the host, metrics, launches, peak bytes)."""
    with peak_memory() as peak:
        out = in_memory(stab, frames_np, device)
    return out + (peak.bytes,)


def check_streamed(name, got, ref):
    """Streamed frames torch.equal to the in-memory route's, metrics equal."""
    import math

    import torch

    frames, metrics = got[0], got[1]
    check(torch.equal(torch_frames(frames), torch_frames(ref[0])),
          f"{name}: streamed frames differ from the in-memory route's")
    same = all(a == b or (math.isnan(a) and math.isnan(b)) for a, b in zip(metrics, ref[1]))
    check(same, f"{name}: streamed metrics {metrics} differ from in-memory {ref[1]}")


def phase_streamed(device, num_frames=300, h=360, w=640, pan=120):
    """The stream (``MeshFlowStabilizer._stream``) on the 640x360 clip
    through an array-backed clip and a capturing writer (no codec), at CHUNK 64 and
    16, each against ``_stabilize_frames`` at the same CHUNK: frames
    torch.equal, metrics equal, the kernels' launch counts; at CHUNK 64 a
    warm pass and a pass with its stages timed."""
    from meshflow_tpu_torch import streaming
    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.utils.profiling import StageTimer

    frames = synthetic_clip(num_frames, h, w, pan=pan)
    clip = streaming.ArrayClip(frames)
    out = {}
    for chunk in (64, 16):
        stab = MeshFlowStabilizer(device=device)
        stab.CHUNK = chunk
        ref = in_memory(stab, frames, device)
        got = run_streamed(stab, clip, device)
        check_streamed(f"streamed CHUNK {chunk}", got, ref)
        lk, bmap = stream_launch_counts(stab.config, h, w, num_frames, chunk)
        launches = got[3]
        check(launches["lk_level"] == lk and launches["backward_map"] == bmap
              and launches["lk_band"] == 0,
              f"streamed CHUNK {chunk}: launches {launches}, expected kernel A {lk}, "
              f"kernel B {bmap}")
        line = (f"streamed CHUNK {chunk}: {num_frames} frames {w}x{h}: frames and metrics "
                f"equal to _stabilize_frames; first pass {got[2]:.3f} s; launches {launches}")
        if chunk == 64:
            warm = run_streamed(stab, clip, device)
            timer = StageTimer(enabled=True, device=device)
            run_streamed(stab, clip, device, timer=timer)
            stages = stage_seconds(timer)
            line += (f"; warm {warm[2]:.3f} s ({num_frames / warm[2]:.2f} fps); stages of a "
                     f"third pass (s, a synchronize at each stage end) {stages}")
            out = {"launches": launches, "first_s": got[2], "warm_s": warm[2],
                   "stages": stages, "clip": frames, "ref": ref}
        print(line + f"; metrics {got[1]}")
    return out


def phase_checkpoint(device, streamed):
    """Checkpoint/resume on the 640x360 clip (CHUNK 64), a checkpoint
    directory under a temporary directory: the first run writes it; a rerun
    under the same variant and one under another variant resume at the
    solve (kernel A runs the metric pass's launches only) and equal fresh
    runs."""
    import tempfile

    import numpy as np

    from meshflow_tpu_torch import streaming
    from meshflow_tpu_torch.api import MeshFlowStabilizer

    frames = streamed["clip"]
    num_frames, h, w = frames.shape[:3]
    stab = MeshFlowStabilizer(device=device)
    levels = stab.config.lk_max_level(h, w) + 1
    metric_lk = levels * -(-num_frames // stab.CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "clip.npy")
        np.save(path, frames)  # the file that stands for the clip in the key
        clip = streaming.ArrayClip(frames, path=path)
        ckpt = os.path.join(tmp, "checkpoints")
        first = run_streamed(stab, clip, device, checkpoint_dir=ckpt)
        files = os.listdir(ckpt)
        check(len(files) == 1, f"checkpoint: {files} after the first run")
        size = os.path.getsize(os.path.join(ckpt, files[0]))
        check_streamed("checkpoint: first run", first, streamed["ref"])
        rows = []
        for variant in (0, 2):
            resumed = run_streamed(stab, clip, device, variant, checkpoint_dir=ckpt)
            fresh = first if variant == 0 else run_streamed(stab, clip, device, variant)
            check_streamed(f"checkpoint: resumed variant {variant}", resumed, fresh)
            check(resumed[3]["lk_level"] == metric_lk,
                  f"checkpoint: variant {variant} ran kernel A {resumed[3]['lk_level']} "
                  f"times, the metric pass alone is {metric_lk}: pass 1 ran")
            rows.append((variant, resumed[2], fresh[2]))
        check(len(os.listdir(ckpt)) == 1, "checkpoint: another variant wrote a checkpoint")
    print(f"checkpoint: {files[0]} ({size} bytes); resumed runs skip pass 1 (kernel A "
          f"{metric_lk} launches, the metric pass) and equal fresh runs: "
          + "; ".join(f"variant {v} resumed {r:.3f} s, fresh {f:.3f} s" for v, r, f in rows))
    return {"bytes": size, "runs": rows}


def torch_frames(frames):
    import torch

    return frames if isinstance(frames, torch.Tensor) else torch.from_numpy(frames)


def phase_memory(device, num_frames=300, h=1080, w=1920, pan=360):
    """Peak device memory at 1920x1080 x 300 frames, d=3, kernel C: the
    in-memory route (the clip uploaded, then ``_stabilize_frames``) against
    the stream (``MeshFlowStabilizer._stream``) with
    MESHFLOW_HBM_FRAME_BUDGET_GB=0; equal outputs."""
    import torch

    from meshflow_tpu_torch import streaming
    from meshflow_tpu_torch.api import MeshFlowStabilizer

    frames = synthetic_clip(num_frames, h, w, pan=pan)
    stab = MeshFlowStabilizer(device=device)
    peaks = {}
    with fetch_route("band"):
        *ref, peaks["in-memory"] = peak_in_memory(stab, frames, device)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pass1 = MeshFlowStabilizer._pass1

        def pass1_peak(*args):  # the peak of pass 1, then of the rest apart
            out = pass1(*args)
            torch.cuda.synchronize()
            peaks["streamed pass 1"] = torch.cuda.max_memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            return out

        os.environ["MESHFLOW_HBM_FRAME_BUDGET_GB"] = "0"
        MeshFlowStabilizer._pass1 = pass1_peak
        try:
            got = run_streamed(stab, streaming.ArrayClip(frames), device)
        finally:
            MeshFlowStabilizer._pass1 = pass1
            del os.environ["MESHFLOW_HBM_FRAME_BUDGET_GB"]
        peaks["streamed solve to pass 2"] = torch.cuda.max_memory_allocated() - base
        peaks["streamed"] = max(peaks["streamed pass 1"], peaks["streamed solve to pass 2"])
    check_streamed("memory 1080p", got, ref)
    lk, bmap = stream_launch_counts(stab.config, h, w, num_frames, stab.CHUNK)
    check(got[3]["lk_band"] == lk and got[3]["lk_level"] == 0
          and got[3]["backward_map"] == bmap,
          f"memory 1080p: streamed launches {got[3]}, expected kernel C {lk}, kernel B {bmap}")
    gib = {k: v / (1 << 30) for k, v in peaks.items()}
    print(f"memory: {num_frames} frames {w}x{h}, d={stab.config.resolve_track_downscale(h, w)}, "
          f"kernel C: peak device memory above the start, in-memory route "
          f"{gib['in-memory']:.3f} GiB, streamed (MESHFLOW_HBM_FRAME_BUDGET_GB=0) "
          f"{gib['streamed']:.3f} GiB (pass 1 {gib['streamed pass 1']:.3f}, solve, crop scan "
          f"and pass 2 {gib['streamed solve to pass 2']:.3f}); outputs equal; streamed {got[2]:.3f} s, launches "
          f"{got[3]}")
    return {"peak_gib": gib, "launches": got[3], "seconds": got[2], "frames": frames}


FOURCC_MP4V = sum(ord(c) << (8 * i) for i, c in enumerate("mp4v"))


def phase_file(device, native_ok, num_frames=300, h=360, w=640, pan=120, fps=30.0):
    """File to file on the card, when the native library loads: the clip
    written with the native writer, ``MeshFlowStabilizer(device).stabilize
    (in, out, 0)``, the output's frame count, fps and shape read back with
    the native reader; decode and encode seconds from the run's timer."""
    import math
    import tempfile

    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.io import native

    if not native_ok:
        print(f"file: skipped: the native library does not load ({native.load_error()}) "
              "and the machine has no cv2, so no clip can be decoded or encoded")
        return None
    frames = synthetic_clip(num_frames, h, w, pan=pan)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.mp4"), os.path.join(tmp, "out.mp4")
        start = time.perf_counter()
        with native.NativeWriter(src, w, h, fps, FOURCC_MP4V) as writer:
            check(writer.write(frames) == num_frames, "file: the native writer dropped frames")
        write_s = time.perf_counter() - start
        stab = MeshFlowStabilizer(device=device)
        start = time.perf_counter()
        metrics = stab.stabilize(src, dst, 0)
        wall = time.perf_counter() - start
        stages = stage_seconds(stab.last_timer)
        with native.NativeReader(dst) as reader:
            count = 0
            while True:
                batch = reader.read(64)
                if len(batch) == 0:
                    break
                count += len(batch)
            shape, out_fps = (reader.height, reader.width), reader.fps
    check(count == num_frames, f"file: the output has {count} frames, not {num_frames}")
    check(abs(out_fps - fps) < 0.01, f"file: output fps {out_fps}, not {fps}")
    check(shape == (h, w), f"file: output frames {shape}, not {(h, w)}")
    check(all(math.isfinite(x) for x in metrics), f"file: metrics {metrics}")
    print(f"file: {num_frames} frames {w}x{h} written by the native encoder in {write_s:.3f} s; "
          f"stabilize(in, out, 0) on {device} in {wall:.3f} s: decode "
          f"{stages.get('decode', 0.0):.3f} s, encode {stages.get('encode', 0.0):.3f} s; "
          f"output {count} frames at {out_fps} fps, {w}x{h}; metrics {metrics}; stages {stages}")
    return {"seconds": wall, "decode_s": stages.get("decode"), "encode_s": stages.get("encode")}


def phase_gray(device, main_bgr, warm_1080p_s, memory, online_bgr, num_frames=300, h=360,
               w=640, pan=120):
    """The gray-plane route (track_planes="gray") on the card, beside the
    BGR runs of this process: the 640x360 x 300 clip in memory (cold, warm,
    crop, metrics, launches of A and B against the reckoned counts); the
    same streamed at CHUNK 64 against it (frames torch.equal, metrics
    equal); the 1080p x 300 clip at d=3 with kernel C (peak device memory
    as ``phase_memory`` takes it, warm wall); online mode over 120 frames."""
    import math

    import torch

    from meshflow_tpu_torch import streaming
    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.config import MeshFlowConfig

    gray = MeshFlowConfig(track_planes="gray")
    out = {}
    frames_np = synthetic_clip(num_frames, h, w, pan=pan)
    frames = torch.from_numpy(frames_np).to(device)
    stab = MeshFlowStabilizer(config=gray, device=device)
    reset_launches()
    torch.cuda.synchronize()
    start = time.perf_counter()
    first = stab._stabilize_frames(frames, 0)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - start
    launches = read_launches()
    start = time.perf_counter()
    second = stab._stabilize_frames(frames, 0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - start
    crop, metrics, mean_dx = check_output("gray", stab, first, num_frames, h, w, pan, device)
    levels = gray.lk_max_level(h, w) + 1
    blocks = math.ceil((num_frames - 1) / (stab.CHUNK - 1)), math.ceil(num_frames / stab.CHUNK)
    check(launches["lk_level"] == levels * sum(blocks) and launches["lk_band"] == 0
          and launches["backward_map"] == blocks[1],
          f"gray: launches {launches}, expected kernel A {levels} x {sum(blocks)}, kernel B "
          f"{blocks[1]} (one map a block, shared by the BGR render and the gray re-render)")
    check(torch.equal(first[0], second[0]), "gray: warm pass output differs from cold pass")
    print(f"gray: {num_frames} frames {w}x{h}, one gray plane tracked, BGR rendered: cold "
          f"{cold_s:.3f} s, warm {warm_s:.3f} s ({num_frames / warm_s:.2f} fps) beside BGR's "
          f"cold {main_bgr[1]:.3f} s, warm {main_bgr[2]:.3f} s; launches {launches}; crop "
          f"{crop}; cropping ratio {metrics[0]:.6f}, distortion {metrics[1]:.6f}, stability "
          f"{metrics[2]:.6f}; last-frame mean x displacement {mean_dx:.3f} px")
    out["main"] = {"cold_s": cold_s, "warm_s": warm_s, "launches": launches, "crop": crop,
                   "metrics": metrics}

    ref = (first[0].cpu(), tuple(float(x) for x in first[1:]))
    del first, second, frames
    got = run_streamed(stab, streaming.ArrayClip(frames_np), device)
    check_streamed("gray streamed CHUNK 64", got, ref)
    lk, bmap = stream_launch_counts(gray, h, w, num_frames, stab.CHUNK)
    check(got[3]["lk_level"] == lk and got[3]["backward_map"] == bmap
          and got[3]["lk_band"] == 0,
          f"gray streamed: launches {got[3]}, expected kernel A {lk}, kernel B {bmap}")
    print(f"gray streamed CHUNK 64: frames and metrics equal to gray _stabilize_frames; "
          f"{got[2]:.3f} s; launches {got[3]}")
    out["streamed"] = {"seconds": got[2], "launches": got[3]}

    frames_np = memory["frames"]
    n, h, w = frames_np.shape[:3]
    stab = MeshFlowStabilizer(config=gray, device=device)
    th, tw = gray.track_shape(h, w)
    with fetch_route("band"):
        cropped, metrics, launches, peak = peak_in_memory(stab, frames_np, device)
        frames = torch.from_numpy(frames_np).to(device)
        start = time.perf_counter()
        again = stab._stabilize_frames(frames, 0)
        torch.cuda.synchronize()
        warm = time.perf_counter() - start
    levels = gray.lk_max_level(th, tw) + 1
    blocks = math.ceil((n - 1) / (stab.CHUNK - 1)), math.ceil(n / stab.CHUNK)
    check(launches["lk_band"] == levels * sum(blocks) and launches["lk_level"] == 0
          and launches["backward_map"] == blocks[1],
          f"gray 1080p: launches {launches}, expected kernel C {levels} x {sum(blocks)}, "
          f"kernel B {blocks[1]}")
    check(torch.equal(again[0].cpu(), cropped), "gray 1080p: warm output differs from cold")
    check(all(math.isfinite(x) for x in metrics), f"gray 1080p: metrics {metrics}")
    gib, bgr_gib = peak / (1 << 30), memory["peak_gib"]["in-memory"]
    print(f"gray 1080p (d={gray.resolve_track_downscale(h, w)}, tracking {tw}x{th}x1, band): "
          f"{n} frames {w}x{h}: warm {warm:.3f} s ({n / warm:.2f} fps) beside BGR's "
          f"{warm_1080p_s:.3f} s; peak device memory of the in-memory route {gib:.3f} GiB "
          f"beside BGR's {bgr_gib:.3f} GiB; launches {launches}; crop "
          f"{stab.last_crop.tolist()}; metrics {metrics}")
    out["1080p"] = {"warm_s": warm, "peak_gib": gib, "launches": launches}
    del frames, again

    online = phase_online(device, config=gray, name="online gray")
    print(f"online gray beside BGR: first frame {online['first_ms']:.3f} ms against "
          f"{online_bgr['first_ms']:.3f}, p50 {online['p50_ms']:.3f} against "
          f"{online_bgr['p50_ms']:.3f}, p90 {online['p90_ms']:.3f} against "
          f"{online_bgr['p90_ms']:.3f}")
    out["online"] = online
    return out


# Kernel B's launches on the sharded path, 640x360 x 300 frames: a shard
# maps its whole block in one call (75 frames at 4 shards, 300 at 1).
SHARDED_BMAP_CASES = {
    "4 shards": (640, 360, 16, 1.5, 75, False),
    "1 shard": (640, 360, 16, 1.5, 300, False),
}


def phase_sharded_kernels(device):
    """Kernels A and B at the launch shapes of ``phase_sharded`` (one launch
    per shard and level, its whole block): A at a 4-shard block's motion
    launch (75 pairs of 16 tiles of 90x160x3) and metric launch (75
    frames, shifted=False) against its plain version with A's gates, and
    at the 1-shard block's motion launch (300 pairs; the plain version
    timed at the first only); B at a 4-shard block (75 frames) and the
    1-shard block (300 frames) equal to its plain version; device ms
    beside the plain version's and the bound."""
    import torch

    from meshflow_tpu_torch.kernels import bmap_cuda
    from meshflow_tpu_torch.render.stabilize import crop_edges

    out = {"max_abs_err": 0.0}
    for name, case, plain_batches in (
        ("motion", LkCase(device, "sharded motion", 75, seed=SEED + 22), 1),
        ("metric", LkCase(device, "sharded metric", 75, shifted=False, seed=SEED + 23), 0),
        ("motion 1 shard", LkCase(device, "sharded motion 1 shard", 300, seed=SEED + 24), 0),
    ):
        out[name], max_err = kernel_a_row(f"kernel A sharded {name}", case, plain_batches)
        out["max_abs_err"] = max(out["max_abs_err"], max_err)
    out["bmap_max_abs_err"] = 0.0
    for name in SHARDED_BMAP_CASES:
        config, stab, unstab, h, w = bmap_inputs(device, name, SHARDED_BMAP_CASES)
        kb = bmap_cuda.backward_map(stab, unstab, config, h, w)
        pb, work = bmap_cuda.backward_map_plain(stab, unstab, config, h, w, return_work=True)
        equal = [bool(torch.equal(k, p)) for k, p in zip(kb, pb)]
        edges_equal = bool(torch.equal(crop_edges(kb, h, w), crop_edges(pb, h, w)))
        check(all(equal) and edges_equal,
              f"kernel B differs from the plain version at the sharded launch ({name}): maps "
              f"and coverage equal {equal}, crop edges equal {edges_equal}")
        cov = pb.covered
        err = max((k - p)[cov].abs().max().item() for k, p in zip(kb[:2], pb[:2]))
        out["bmap_max_abs_err"] = max(out["bmap_max_abs_err"], err)
        bound_ms, bound_by, _ = bmap_bound(config, stab, unstab, work)
        del kb, pb, work
        ms = device_ms(lambda: bmap_cuda.backward_map(stab, unstab, config, h, w))
        plain_ms = device_ms(lambda: bmap_cuda.backward_map_plain(stab, unstab, config, h, w),
                             launches=1, batches=1)
        print(f"kernel B sharded {name} ({stab.shape[0]} frames 640x360, mesh 16): map_x, "
              f"map_y, covered and crop edges equal to the plain version; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        out[f"bmap {name}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                               "bound_by": bound_by}
    return out


def shard_count_gates(name, one, many):
    """The JAX package's shard-count gates on two runs (frames, crop,
    metrics, ...) of ``stabilize_sharded``: crop equal, metrics within 1e-3
    relative, frames <= 1 LSB apart on > 99.9% of pixels.  Returns (metric
    rel diffs, share of pixels within 1 LSB)."""
    check(one[1] == many[1], f"{name}: crops {one[1]} (1 shard) and {many[1]} differ")
    rel = [abs(a - b) / max(abs(b), 1e-12) for a, b in zip(many[2], one[2])]
    check(max(rel) <= 1e-3, f"{name}: metrics off the 1-shard run by {rel}")
    near = ((many[0].int() - one[0].int()).abs() <= 1).float().mean().item()
    check(near > 0.999, f"{name}: frames within 1 LSB on {near} of pixels")
    return rel, near


def processes_of(devices):
    """How a parallel call over `devices` ran: its process count, the
    group's backend and each worker's peak device memory (GiB), CPU
    seconds and CUDA graphs (captures, replays) in its last call (one
    entry: the calling process)."""
    import torch

    from meshflow_tpu_torch.parallel import workers

    if len(devices) == 1:
        return {"processes": 1, "backend": None, "peak_gib": [], "cpu_seconds": [],
                "graphs": []}
    pool = workers.pool([torch.device(d) for d in devices])
    return {"processes": len(pool.procs), "backend": pool.backend,
            "peak_gib": [(u["peak_bytes"] or 0) / (1 << 30) for u in pool.last_usage],
            "cpu_seconds": [u["cpu_seconds"] for u in pool.last_usage],
            "graphs": [u["graphs"] for u in pool.last_usage]}


def card_used_gib() -> float:
    """Device memory in use on the card by every process (mem_get_info)."""
    import torch

    free, total = torch.cuda.mem_get_info()
    return (total - free) / (1 << 30)


def card_memory_mib() -> dict:
    """{pid: MiB of the card} of every process on it, as nvidia-smi lists
    its compute processes (empty where it cannot)."""
    try:
        text = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    rows = {}
    for line in text.splitlines():
        try:
            pid, mib = (int(x) for x in line.split(","))
        except ValueError:
            continue
        rows[pid] = mib
    return rows


def timed_parallel(fn):
    """(fn(), wall seconds), the card synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def thread_cpu(pid: int | None = None) -> dict:
    """{thread id: (name, CPU seconds)} of a process's threads (this one by
    default): utime + stime from /proc/PID/task/*/stat; empty where /proc
    cannot be read."""
    pid = os.getpid() if pid is None else pid
    ticks = os.sysconf("SC_CLK_TCK")
    out = {}
    try:
        tids = os.listdir(f"/proc/{pid}/task")
    except OSError:
        return out
    for tid in tids:
        try:
            with open(f"/proc/{pid}/task/{tid}/stat") as f:
                stat = f.read()
        except OSError:  # the thread ended meanwhile
            continue
        name = stat[stat.index("(") + 1 : stat.rindex(")")]
        fields = stat[stat.rindex(")") + 2 :].split()
        out[int(tid)] = ("main" if int(tid) == pid else name,
                         (int(fields[11]) + int(fields[12])) / ticks)
    return out


class cpu_use:
    """CPU seconds over a block of this process and of the live worker
    pool's processes (those up when it starts), each with its busiest
    threads: `by_process` maps "caller" or "worker i" to {"seconds",
    "threads": [[name, seconds, how many threads of that name], ...]}."""

    def __enter__(self):
        from meshflow_tpu_torch.parallel import workers

        live = workers.current()
        self.pids = {"caller": os.getpid()}
        self.pids.update({f"worker {i}": p.pid for i, p in enumerate(live.procs if live else [])})
        self.before = {name: thread_cpu(pid) for name, pid in self.pids.items()}
        return self

    def __exit__(self, *exc):
        self.by_process = {}
        for name, pid in self.pids.items():
            after, before = thread_cpu(pid), self.before[name]
            by_name = {}
            for tid, (thread, seconds) in after.items():
                used = seconds - before.get(tid, (thread, 0.0))[1]
                total, count = by_name.get(thread, (0.0, 0))
                by_name[thread] = (total + used, count + 1)
            threads = sorted(([t, round(s, 3), n] for t, (s, n) in by_name.items() if s > 0),
                             key=lambda x: -x[1])
            self.by_process[name] = {"seconds": sum(t[1] for t in threads),
                                     "threads": threads[:4]}

    def line(self) -> str:
        return "; ".join(
            f"{name} {u['seconds']:.3f} s (" + ", ".join(f"{t} x{n} {s}" for t, s, n in
                                                        u["threads"]) + ")"
            for name, u in self.by_process.items())


def kernel_busy_seconds(prof, device_index: int) -> float:
    """The seconds one card ran kernels (the union of their intervals) in a
    ``torch.profiler`` run."""
    from torch.autograd import DeviceType

    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.device_index == device_index
    )
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    return busy * 1e-6


def kernel_share(device, run):
    """`run()` once more in this process with the card's kernels traced
    (``torch.profiler``, CUDA activity only): (wall seconds, seconds the
    card ran kernels).  Not for worker processes: traced in several
    processes at once, runs took 4 to 11 times their wall, on one card or
    on four; ``card_utilization`` reads those."""
    import torch

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, wall = timed_parallel(run)
    index = torch.device(device).index
    return wall, kernel_busy_seconds(prof, torch.cuda.current_device() if index is None else index)


class card_utilization:
    """nvidia-smi's utilization.gpu of every card (the share of its sample
    period in which a kernel of any process ran), read every 50 ms while
    the block runs: `share` maps a card's index to the mean of the samples
    stamped inside the block (empty where nvidia-smi gives no number)."""

    def __enter__(self):
        self.share, self.proc = {}, None
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=timestamp,index,utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "50"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self
        time.sleep(1.0)  # its first samples
        self.start = datetime.datetime.now()
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return
        end = datetime.datetime.now()
        self.proc.terminate()
        out = self.proc.communicate(timeout=30)[0]
        samples = {}
        for line in out.splitlines():
            try:
                stamp, index, util = (x.strip() for x in line.split(","))
                at = datetime.datetime.strptime(stamp, "%Y/%m/%d %H:%M:%S.%f")
                value = float(util) / 100
            except ValueError:
                continue
            if self.start <= at <= end:
                samples.setdefault(int(index), []).append(value)
        self.share = {i: sum(v) / len(v) for i, v in samples.items()}


def host_round_trip_s(frames):
    """The sharded path's extra host round trip for `frames` on the card:
    the clip into a shared host tensor, and a host output of its size back
    to the card (seconds, the second of two tries)."""
    import torch

    shared = torch.empty(frames.shape, dtype=torch.uint8).share_memory_()
    for _ in range(2):
        _, down = timed_parallel(lambda: shared.copy_(frames))
        _, up = timed_parallel(lambda: shared.to(frames.device))
    return down + up


def staged_rank(rank, world, frames, out, sent, key, config, h, w, mode, trace=False):
    """``pipeline._shard_rank`` in a worker, rank 0's stages timed with the
    card synchronized at each stage's ends, so that they add up: "start"
    (from the caller's send to the task's start: the task unpickled, the
    shared buffers' handles received and mapped), "upload" (the rank's
    block to the card), "ppermute" / "all_gather" / "halo" (each kind of
    collective: the staging through the host, the wire and the wait for
    the peer), "compute" (the rest of ``shard_step``) and "write" (the
    cropped block into the shared output).  With `trace`, rank 0's step
    runs under ``torch.profiler`` instead and "kernels" is the seconds its
    card ran its kernels.  Returns (the rank's results, the stages or
    None)."""
    import torch

    from meshflow_tpu_torch.parallel import pipeline, workers

    if rank:
        return pipeline._shard_rank(rank, world, frames, out, key, config, h, w, 0, mode), None
    device = workers.device()
    stages = {"start": time.time() - sent}
    comm = workers.Collectives(rank, world, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(name, fn):
        def run(*args):
            sync()
            start = time.perf_counter()
            got = fn(*args)
            sync()
            stages[name] = stages.get(name, 0.0) + time.perf_counter() - start
            return got
        return run

    collectives = ("ppermute", "all_gather", "halo")
    if not trace:
        for name in collectives:
            setattr(comm, name, timed(name, getattr(comm, name)))
    block = frames.shape[0] // world
    rows = slice(rank * block, (rank + 1) * block)
    local = timed("upload", lambda: frames[rows].to(device))()
    args = (local, key.to(device), config, h, w, frames.shape[0], 0, mode, comm)
    if trace:
        kind = "CUDA" if device.type == "cuda" else "CPU"  # CPU: a rehearsal, no kernels
        with torch.profiler.profile(activities=[getattr(torch.profiler.ProfilerActivity, kind)]) as prof:
            got = timed("step", lambda: pipeline.shard_step(*args))()
        stages["kernels"] = kernel_busy_seconds(prof, device.index)
    else:
        got = timed("compute", lambda: pipeline.shard_step(*args))()
        stages["compute"] -= sum(stages.get(n, 0.0) for n in collectives)
    timed("write", lambda: out[rows].copy_(got[0]))()
    return tuple(x.cpu() for x in got[1:]), stages


def sharded_stages(devices, frames, key, config, h, w, trace=False):
    """One ``stabilize_sharded`` call over worker processes taken apart,
    as ``pipeline._over_ranks`` makes it: the caller's "copy in" (the clip
    into the pool's shared buffer), "ranks" (from the first send to the
    last answer) and "copy out" (the shared output to the first device);
    and rank 0's stages (``staged_rank``).  Returns ({stage: seconds},
    rank 0's result)."""
    import torch

    from meshflow_tpu_torch.parallel import workers

    world = len(devices)
    # stabilize_sharded's choice: blocks shorter than omega solve replicated
    block = frames.shape[0] // world
    mode = "halo" if block >= config.temporal_smoothing_radius else "replicated"
    pool = workers.pool([torch.device(d) for d in devices])
    pool.init_group()
    torch.cuda.synchronize()
    start = time.perf_counter()
    shared = pool.shared("in", frames.shape, frames.dtype)
    shared.copy_(frames)
    out = pool.shared("out", frames.shape, frames.dtype)
    copied = time.perf_counter()
    results = pool.each(staged_rank, [(r, world, shared, out, time.time(), key.cpu(), config, h,
                                       w, mode, trace) for r in range(world)])
    ranked = time.perf_counter()
    back = out.to(devices[0], copy=True)
    torch.cuda.synchronize()
    stages = {"copy in": copied - start, "ranks": ranked - copied,
              "copy out": time.perf_counter() - ranked}
    stages.update({f"rank 0 {k}": v for k, v in results[0][1].items()})
    return stages, (back,) + results[0][0]


def phase_sharded(device, num_frames=300, h=360, w=640, pan=120):
    """``parallel.stabilize_sharded`` on the 640x360 x 300 clip, its shards
    over ["cuda:0"] (the calling process) and ["cuda:0"] * 4 (four worker
    processes, a gloo group; blocks of 75 >= omega, so the halo solver
    engages): crop equal, metrics within 1e-3 relative, frames <= 1 LSB
    apart on > 99.9% of pixels (the JAX package's shard-count gates); at 4
    shards "halo" torch.equal to "replicated"; serving mode the same pixels
    and NaN metrics; the cold and warm wall of 1 and 4 shards, the wall of
    the others, launches summed over the processes, the backend, each
    worker's peak device memory and the host round trip of the clip."""
    import math

    import torch

    from meshflow_tpu_torch.config import MeshFlowConfig
    from meshflow_tpu_torch.parallel import workers
    from meshflow_tpu_torch.parallel.pipeline import stabilize_sharded
    from meshflow_tpu_torch.utils import prng

    config = MeshFlowConfig()
    frames = torch.from_numpy(synthetic_clip(num_frames, h, w, pan=pan)).to(device)
    key = prng.PRNGKey(SEED, device=device)
    levels = config.lk_max_level(h, w) + 1
    runs, out = {}, {}
    for name, shards, mode, cfg in (
        ("1 shard cold", 1, "halo", config),
        ("1 shard", 1, "halo", config),
        ("4 shards cold", 4, "halo", config),
        ("4 shards", 4, "halo", config),
        ("4 shards replicated", 4, "replicated", config),
        ("4 shards serving", 4, "halo", MeshFlowConfig(compute_metrics=False)),
    ):
        devices = [device + ":0"] * shards
        reset_launches()
        with cpu_use() as cpu:
            res, wall = timed_parallel(lambda: stabilize_sharded(
                frames, key, cfg, h, w, devices=devices, solver_mode=mode))
        launches = read_launches()
        procs = processes_of(devices)
        metrics = tuple(float(x) for x in res[2:])
        runs[name] = (res[0], res[1].tolist(), metrics)
        lk = levels * shards * (2 if cfg.compute_metrics else 1)
        check(launches["lk_level"] == lk and launches["backward_map"] == shards
              and launches["lk_band"] == 0,
              f"sharded {name}: launches {launches}, expected kernel A {lk}, kernel B {shards}")
        check(tuple(res[0].shape) == (num_frames, h, w, 3) and res[0].dtype == torch.uint8
              and res[0].device == torch.device(devices[0]),
              f"sharded {name}: output {tuple(res[0].shape)} {res[0].dtype} {res[0].device}")
        out[name] = {"seconds": wall, "launches": launches, "cpu": cpu.by_process, **procs}
        print(f"sharded {name}: {num_frames} frames {w}x{h}: {wall:.3f} s; "
              f"{procs['processes']} process(es), backend {procs['backend']}, worker peak GiB "
              f"{[round(x, 3) for x in procs['peak_gib']]}, worker CPU s "
              f"{[round(x, 3) for x in procs['cpu_seconds']]}, worker graph captures and "
              f"replays {procs['graphs']}; CPU {cpu.line()}; crop "
              f"{runs[name][1]}; metrics {metrics}; launches {launches}")
        check(all(r > 0 for _, r in procs["graphs"]),
              f"sharded {name}: a rank replayed no graph ({procs['graphs']})")
    out["card_used_gib"] = card_used_gib()
    pids = {p.pid: f"worker {i}" for i, p in enumerate(workers.current().procs)}
    pids[os.getpid()] = "caller"
    by_pid = card_memory_mib()
    out["idle_mib"] = {pids.get(pid, str(pid)): mib for pid, mib in by_pid.items()}
    workers.shutdown()
    one, four = runs["1 shard"], runs["4 shards"]
    rel, near = shard_count_gates("sharded", one, four)
    check(torch.equal(four[0], runs["4 shards cold"][0]) and four[1:] == runs["4 shards cold"][1:],
          "sharded: the warm 4-shard run differs from the cold one")
    rep = runs["4 shards replicated"]
    check(torch.equal(four[0], rep[0]) and four[1:3] == rep[1:3],
          "sharded: halo solve differs from the replicated one")
    serve = runs["4 shards serving"]
    check(torch.equal(serve[0], four[0]) and serve[1] == four[1]
          and all(math.isnan(x) for x in serve[2][:2]) and serve[2][2] == four[2][2],
          "sharded: serving mode differs")
    out["host_round_trip_s"] = host_round_trip_s(frames)
    print(f"sharded: 4 shards against 1: crop equal, metric rel diffs {rel}, frames within "
          f"1 LSB on {near:.6f} of pixels; halo torch.equal to replicated; serving mode same "
          f"pixels, NaN metrics; card memory in use with the 4 workers up "
          f"{out['card_used_gib']:.3f} GiB, by process (nvidia-smi, MiB; the workers idle) "
          f"{out['idle_mib']}; the clip's host round trip "
          f"{out['host_round_trip_s']:.4f} s")
    return out


def phase_batch(device, num_frames=120, h=360, w=640):
    """``parallel.stabilize_batch`` on two 640x360 x 120-frame clips
    (``streaming.ArrayClip`` in, ``CaptureWriter`` out: the card has no
    codec) with devices ["cuda:0"] (one worker, the calling process) and
    ["cuda:0"] * 2 (two worker processes on one card), each twice (cold,
    warm): each job's metrics and frames equal a solo ``stabilize`` of its
    clip; the wall of each run, its launches summed over the processes and
    each worker's CPU seconds and peak device memory."""
    import torch

    from meshflow_tpu_torch import streaming
    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.parallel import workers
    from meshflow_tpu_torch.parallel.batch import BatchJob, stabilize_batch

    clips = [synthetic_clip(num_frames, h, w, pan=60 + 30 * i) for i in range(2)]
    solo = []
    for frames in clips:
        writer = streaming.CaptureWriter()
        metrics = MeshFlowStabilizer(device=device).stabilize(
            streaming.ArrayClip(frames), writer, 0)
        solo.append((writer.frames(), metrics))
    stab = MeshFlowStabilizer(device=device)
    lk, bmap = stream_launch_counts(stab.config, h, w, num_frames, stab.CHUNK)
    out = {}
    for workers_n, run in ((1, "cold"), (1, "warm"), (2, "cold"), (2, "warm")):
        devices = [device + ":0"] * workers_n
        jobs = [BatchJob(streaming.ArrayClip(f), streaming.CaptureWriter(), 0) for f in clips]
        reset_launches()
        with card_utilization() as smi, cpu_use() as cpu:
            results, wall = timed_parallel(lambda: stabilize_batch(jobs, devices=devices))
        launches = read_launches()
        procs = processes_of(devices)
        for i, (job, metrics) in enumerate(zip(jobs, results)):
            check(metrics == solo[i][1],
                  f"batch ({workers_n} workers): job {i} metrics {metrics} != solo {solo[i][1]}")
            check(torch.equal(torch_frames(job.output_path.frames()), torch_frames(solo[i][0])),
                  f"batch ({workers_n} workers): job {i} frames differ from the solo run's")
        check(launches["lk_level"] == 2 * lk and launches["backward_map"] == 2 * bmap
              and launches["lk_band"] == 0,
              f"batch ({workers_n} workers): launches {launches}, expected kernel A {2 * lk}, "
              f"kernel B {2 * bmap}")
        print(f"batch: 2 clips x {num_frames} frames {w}x{h} on {workers_n} worker(s) of one "
              f"card, {run}: {wall:.3f} s; {procs['processes']} process(es), worker CPU s "
              f"{[round(x, 3) for x in procs['cpu_seconds']]}, worker peak GiB "
              f"{[round(x, 3) for x in procs['peak_gib']]}, worker graph captures and "
              f"replays {procs['graphs']}; card busy (nvidia-smi) "
              f"{smi.share}; CPU {cpu.line()}; each job's frames and metrics equal its solo "
              f"run; launches {launches}")
        check(all(r > 0 for _, r in procs["graphs"]),
              f"batch ({workers_n} workers): a worker replayed no graph ({procs['graphs']})")
        out[workers_n if run == "warm" else f"{workers_n} cold"] = {
            "seconds": wall, "launches": launches, "smi_busy": smi.share, "cpu": cpu.by_process,
            **procs}
        if run == "warm" and workers_n == 1:
            def again():
                return stabilize_batch([BatchJob(streaming.ArrayClip(f), streaming.CaptureWriter(),
                                                 0) for f in clips], devices=devices)

            prof_wall, busy = kernel_share(devices[0], again)
            out[workers_n].update(profiled_seconds=prof_wall, kernel_seconds=busy)
            print(f"batch: {workers_n} worker(s), profiled again: {prof_wall:.3f} s, kernels "
                  f"{busy:.3f} s, busy share of the card {busy / prof_wall:.4f}")
    workers.shutdown()
    return out


# ---------------------------------------------------------------------------
# The JAX package's other clip geometries: 4K (d=5), 1080p on the 64x64
# mesh, 720p (d=2), serving mode, and the sharded path at 4K.


def peak_rss_gib() -> float:
    """The process's peak resident set so far (ru_maxrss), GiB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)


def host_ram_gib() -> float:
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / (1 << 30)


class pass2_sources:
    """Records where each block of the stream's pass 2 took its frames:
    (start, frames, "resident" | "host cache" | "decode"), and the resident
    prefix's length (``resident``)."""

    def __enter__(self):
        from meshflow_tpu_torch import streaming

        self.blocks, self.resident = [], 0
        self.original = original = streaming.HostFrames.host_frames

        def host_frames(pipe, start, n):
            self.resident = pipe.res_end
            if start + n <= pipe.res_end:
                source = "resident"
            else:
                source = "host cache" if pipe.host_cache is not None else "decode"
            self.blocks.append((start, n, source))
            return original(pipe, start, n)

        streaming.HostFrames.host_frames = host_frames
        return self

    def __exit__(self, *exc):
        from meshflow_tpu_torch import streaming

        streaming.HostFrames.host_frames = self.original

    def sources(self):
        return {source for _, _, source in self.blocks}

    def summary(self) -> str:
        return ", ".join(f"{s}-{s + n - 1} {source}" for s, n, source in sorted(self.blocks))


# Kernel B at the new geometries' render launches (a 64-frame block): 4K
# on the 16x16 mesh (vertex noise scaled with the width from the main
# case's 1.5 px) and 1080p on the 64x64 mesh.
GEOMETRY_BMAP_CASES = {
    "4K": (3840, 2160, 16, 9.0, 64, False),
    "1080p/64 block": (1920, 1080, 64, 3.0, 64, False),
}
# Frames of a block the plain backward map takes at a time
BMAP_SLAB = 16


def phase_geometry_kernels(device, bmap_cases=GEOMETRY_BMAP_CASES, size=(2160, 3840)):
    """Kernels A, C and B at the launch shapes of the new geometries.  A
    against its plain version with A's gates, its device ms beside the
    plain version's and the bound, at the 4K launches (d=5 tracks at
    768x432: 16 tiles of 108x192x3, 3 levels), the 63-pair motion block and
    the 64-frame metric block, and at the sharded path's 4K launches (no
    track geometry: 16 tiles of 540x960x3, 4 levels), a 1-shard block's
    15-pair motion and 16-frame metric launches; C at the 4K motion launch
    bit for bit against A; B at a 64-frame 4K block and a 64-frame 1080p
    block on the 64x64 mesh (its global-table route), map_x, map_y,
    covered and crop edges equal to the plain version on every frame (the
    plain version BMAP_SLAB frames at a time, counting its work), device
    ms of the whole block beside the plain version's summed over its slabs
    and the bound from the work its data needs."""
    import torch

    from meshflow_tpu_torch.config import MeshFlowConfig
    from meshflow_tpu_torch.kernels import bmap_cuda, lk_cuda
    from meshflow_tpu_torch.render.stabilize import crop_edges

    config = MeshFlowConfig()
    th, tw = config.track_shape(*size)
    sub_h, sub_w = config.subframe_shape(th, tw)
    levels = config.lk_max_level(th, tw)
    full_h, full_w = config.subframe_shape(*size)
    full_levels = config.lk_max_level(*size)
    sharded_frames = 16  # the sharded 4K phase's clip, on one shard
    # a pair of a case moves up to 2 x max_shift px; one of the sharded
    # clip up to 36 / 15 px of pan and 6 of jitter
    lk = {
        "A": LkCase(device, "4K motion", 63, th=sub_h, tw=sub_w, max_level=levels,
                    seed=SEED + 32),
        "A 4K metric": LkCase(device, "4K metric", 64, shifted=False, th=sub_h, tw=sub_w,
                              max_level=levels, seed=SEED + 33),
        "A sharded 4K motion": LkCase(device, "sharded 4K motion", sharded_frames - 1,
                                      th=full_h, tw=full_w, max_level=full_levels,
                                      max_shift=10, seed=SEED + 34),
        "A sharded 4K metric": LkCase(device, "sharded 4K metric", sharded_frames,
                                      shifted=False, th=full_h, tw=full_w,
                                      max_level=full_levels, max_shift=10, seed=SEED + 35),
    }
    out = {}
    for key, case in lk.items():
        out[key], max_err = kernel_a_row(f"kernel A {case.name}", case, 1)
        out[key]["max_abs_err"] = max_err
    case = lk["A"]

    def band():
        with fetch_route("band"):
            return case.track()

    cp, cst = band()
    ap, ast = case.track(lk_cuda.lk_level)
    check(torch.equal(cp, ap) and torch.equal(cst, ast),
          "kernel C differs from kernel A at the 4K motion launch")
    ms = device_ms(band) / case.levels
    out["C"] = {k: out["A"][k] for k in ("plain_ms", "bound_ms", "bound_by", "max_abs_err")}
    out["C"]["ms"] = ms
    print(f"kernel C 4K motion per launch ({case.shape}): corners and status bit-identical to "
          f"kernel A; kernel C {ms:.4f} ms, kernel A {out['A']['ms']:.4f} ms")
    del cp, cst, ap, ast, lk, case

    for name in bmap_cases:
        config, stab, unstab, bh, bw = bmap_inputs(device, name, bmap_cases)
        kb = bmap_cuda.backward_map(stab, unstab, config, bh, bw)
        edges = crop_edges(kb, bh, bw)
        count, err, plain_ms = {}, 0.0, 0.0
        for s in range(0, stab.shape[0], BMAP_SLAB):
            sl = slice(s, s + BMAP_SLAB)
            torch.cuda.synchronize()
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            pb, work = bmap_cuda.backward_map_plain(stab[sl], unstab, config, bh, bw,
                                                    return_work=True)
            end.record()
            end.synchronize()
            plain_ms += begin.elapsed_time(end)
            equal = [bool(torch.equal(k[sl], p)) for k, p in zip(kb, pb)]
            edges_equal = bool(torch.equal(edges[sl], crop_edges(pb, bh, bw)))
            check(all(equal) and edges_equal,
                  f"kernel B differs from the plain version ({name}, frames {s}..): maps and "
                  f"coverage equal {equal}, crop edges equal {edges_equal}")
            cov = pb.covered
            err = max([err] + [(k[sl] - p)[cov].abs().max().item()
                               for k, p in zip(kb[:2], pb[:2]) if cov.any()])
            for k, v in work.items():
                count[k] = count.get(k, 0) + int(v.sum())
            del pb, work
        pixels = kb.covered.numel()
        del kb, edges
        bound_ms, bound_by, _ = bmap_bound_of(config, stab, unstab, count, pixels)
        ms = device_ms(lambda: bmap_cuda.backward_map(stab, unstab, config, bh, bw))
        print(f"kernel B {name} ({stab.shape[0]} frames {bw}x{bh}, mesh "
              f"{config.mesh_row_count}): map_x, map_y, covered and crop edges equal to the "
              f"plain version on every frame; a pixel needs "
              + ", ".join(f"{v / pixels:.4f} {k}" for k, v in count.items())
              + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (its {BMAP_SLAB}-frame slabs, "
              f"work counted, summed), bound {bound_ms:.4f} ms ({bound_by})")
        out[f"B {name}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by, "max_abs_err": err}
        del stab, unstab
    return out


def streamed_against(name, run, frames_np, device, **env):
    """The stream (``MeshFlowStabilizer._stream``) of `frames_np` (an array
    clip into a capturing writer) under the environment `env`, against the in-memory `run`
    (``in_memory_passes``, its output on the host as run["ref"]): frames
    torch.equal, metrics equal, launches as reckoned; which branch served
    each block of pass 2, the peak device memory and the process's peak
    RSS."""
    from meshflow_tpu_torch import streaming

    stab = run["stab"]
    num_frames, h, w = frames_np.shape[:3]
    with env_set(**env), pass2_sources() as sources, peak_memory() as peak:
        got = run_streamed(stab, streaming.ArrayClip(frames_np), device)
    check_streamed(name, got, run["ref"])
    lk, bmap = stream_launch_counts(stab.config, h, w, num_frames, stab.CHUNK)
    check(got[3] == {"lk_level": lk, "lk_band": 0, "backward_map": bmap},
          f"{name}: launches {got[3]}, expected kernel A {lk}, kernel B {bmap}")
    rss = peak_rss_gib()
    budgets = " ".join(f"{k}={v}" for k, v in env.items()) or "default budgets"
    print(f"{name}: {num_frames} frames {w}x{h}, {budgets}: frames and metrics "
          f"equal to _stabilize_frames; {got[2]:.3f} s; launches {got[3]}; resident prefix "
          f"{sources.resident} frames; pass 2 blocks: {sources.summary()}; peak device memory "
          f"{peak.gib:.3f} GiB; process peak RSS {rss:.3f} GiB")
    return {"seconds": got[2], "launches": got[3], "resident": sources.resident,
            "sources": sorted(sources.sources()), "peak_gib": peak.gib, "peak_rss_gib": rss}


def serving_against(name, device, frames, config, ref, ref_walls):
    """Serving mode (compute_metrics=False) in memory on the device frames
    `frames`, twice, against the metrics-on output `ref` (cropped,
    ratio, distortion, stability) of the same config: frames torch.equal
    (the JAX CLI promises bit-identical output), the two area scores NaN,
    stability equal, kernel A launched for the motion blocks only; the
    walls beside the metrics-on walls `ref_walls` (cold, warm)."""
    import math

    import torch

    from meshflow_tpu_torch.api import MeshFlowStabilizer

    num_frames, h, w = frames.shape[:3]
    stab = MeshFlowStabilizer(config=config, compute_metrics=False, device=device)
    walls = []
    for _ in range(2):
        reset_launches()
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = stab._stabilize_frames(frames, 0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
        launches = read_launches()
        check(torch.equal(out[0], ref[0]), f"{name} serving: frames differ from metrics-on")
        scores = tuple(float(x) for x in out[1:])
        del out
    check(math.isnan(scores[0]) and math.isnan(scores[1]),
          f"{name} serving: area scores {scores[:2]} are not NaN")
    check(scores[2] == float(ref[3]), f"{name} serving: stability {scores[2]} != {ref[3]}")
    lk, bmap = stream_launch_counts(stab.config, h, w, num_frames, stab.CHUNK)
    check(launches == {"lk_level": lk, "lk_band": 0, "backward_map": bmap},
          f"{name} serving: launches {launches}, expected kernel A {lk}, kernel B {bmap}")
    print(f"{name} serving (compute_metrics=False): {num_frames} frames {w}x{h}: first "
          f"{walls[0]:.3f} s, second {walls[1]:.3f} s beside metrics-on cold {ref_walls[0]:.3f} "
          f"s, warm {ref_walls[1]:.3f} s; frames torch.equal to metrics-on, area scores NaN, "
          f"stability equal; launches {launches}")
    return {"walls": walls, "launches": launches}


def phase_4k(device, num_frames=300, h=2160, w=3840, pan=720):
    """3840x2160 x 300 frames at the automatic track geometry (d=5,
    tracking at 768x432), kernel A: in memory (``in_memory_passes``), then
    serving mode on the same frames against it, then streamed with the
    default budgets (a resident prefix on the card, the rest of pass 2
    from the host cache) and with MESHFLOW_HOST_FRAME_CACHE_GB=0 (the rest
    decoded from the clip again), both equal to in memory."""
    from meshflow_tpu_torch.config import MeshFlowConfig

    config = MeshFlowConfig()
    frames_np = synthetic_clip(num_frames, h, w, pan=pan)
    print(f"4K: host RAM {host_ram_gib():.1f} GiB; the clip {frames_np.nbytes / 1e9:.2f} GB; "
          f"process peak RSS {peak_rss_gib():.3f} GiB")
    run = in_memory_passes("4K", device, frames_np, config, pan, eager_peak=True)
    out = run["out"]
    serving = serving_against("4K", device, run["frames"], config, out,
                              (run["cold_s"], run["warm_s"]))
    run["ref"] = (out[0].cpu(), run["metrics"])
    del run["frames"], run["out"], out
    streamed = {
        "default": streamed_against("4K streamed", run, frames_np, device),
        "no host cache": streamed_against("4K streamed", run, frames_np, device,
                                          MESHFLOW_HOST_FRAME_CACHE_GB="0"),
    }
    check(streamed["default"]["sources"] == ["host cache", "resident"],
          f"4K streamed: pass 2 took {streamed['default']['sources']}, not the resident "
          "prefix and the host cache")
    check(streamed["no host cache"]["sources"] == ["decode", "resident"],
          f"4K streamed without the host cache: pass 2 took "
          f"{streamed['no host cache']['sources']}, not the resident prefix and a decode")
    release_graphs("4K", run.pop("stab"))
    del run["ref"]
    return dict(run, serving=serving, streamed=streamed)


def phase_geometry(device, name, config, num_frames, h, w, pan, eager_peak=False):
    """A clip of another geometry in memory (``in_memory_passes``, with
    `eager_peak` an eager pass's peak too) and streamed with the default
    budgets, torch.equal to it; the stabilizer closed at the end."""
    frames_np = synthetic_clip(num_frames, h, w, pan=pan)
    run = in_memory_passes(name, device, frames_np, config, pan, eager_peak=eager_peak)
    run["ref"] = (run["out"][0].cpu(), run["metrics"])
    del run["frames"], run["out"]
    run["streamed"] = streamed_against(f"{name} streamed", run, frames_np, device)
    del run["ref"]
    release_graphs(name, run.pop("stab"))
    return run


def phase_mesh64(device, stages_16, num_frames=300, h=1080, w=1920, pan=360):
    """1080p x 300 on the 64x64 mesh (d=3, kernel A), in memory and
    streamed; its motion stage beside the 16x16 mesh's (`stages_16`, the
    1080p phase's, kernel C)."""
    from meshflow_tpu_torch.config import MeshFlowConfig

    config = MeshFlowConfig(mesh_row_count=64, mesh_col_count=64)
    run = phase_geometry(device, "1080p/64", config, num_frames, h, w, pan, eager_peak=True)
    print(f"1080p/64: motion stage {run['stages']['motion']:.4f} s beside the 16x16 mesh's "
          f"{stages_16['motion']:.4f} s (1080p phase, kernel C); metrics "
          f"{run['stages']['metrics']:.4f} s beside {stages_16['metrics']:.4f} s")
    return run


def phase_serving(device, main, main_walls, num_frames=300, h=360, w=640, pan=120):
    """Serving mode at 640x360 x 300 against the main path's cold pass
    `main` (``serving_against``)."""
    import torch

    from meshflow_tpu_torch.config import MeshFlowConfig

    frames = torch.from_numpy(synthetic_clip(num_frames, h, w, pan=pan)).to(device)
    return serving_against("640x360", device, frames, MeshFlowConfig(), main, main_walls)


# The host's CUDA calls that launch work, as torch.profiler names them.
KERNEL_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


# The hand kernels each wrapper counts, by the name the card's trace gives
# them (kernel B's entry point launches its table kernel and one map_kernel).
KERNEL_NAMES = {"lk_level": "lk_level_kernel", "lk_band": "lk_band_kernel",
                "backward_map": "map_kernel", "eig9": "eig9_kernel"}
KERNEL_NAME_RE = re.compile(
    r"(?:^|[\s:])(" + "|".join(KERNEL_NAMES.values()) + r")(?:<[^()]*>)?\(")


def named_kernels(names) -> dict:
    """How many of the kernels the card ran (their trace names) were each
    wrapper's kernel."""
    wrapper = {kernel: w for w, kernel in KERNEL_NAMES.items()}
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    for name in names:
        match = KERNEL_NAME_RE.search(name or "")
        if match:
            counts[wrapper[match.group(1)]] += 1
    return counts


def counted_launches() -> dict:
    """Every wrapper's launches since ``reset_launches``, eig9's too."""
    return dict(read_launches(), eig9=eig9_launches())


def trace_launches(stab, frames, device, route):
    """One pass of ``_stabilize_frames`` on `frames` traced stage by stage
    (MESHFLOW_TRACE_DIR, into a temporary directory under build/ that is
    removed after): per stage the host's kernel launches, its graph
    launches, its copies, the kernels the card ran and, by name, those of
    the hand kernels (``named_kernels``).  Gate: the hand kernels the card
    ran, by name, equal the wrappers' counts over the same pass, so that a
    replayed graph's counts are measured, not only recorded.  A whole
    640x360 pass's traces run to about a GB of JSON, so the graphs phase
    traces its first 64 frames: one motion block, one metric block, one
    render block."""
    import json
    import shutil
    import tempfile

    from meshflow_tpu_torch.utils.profiling import StageTimer

    root = Path(__file__).resolve().parent / "build"
    root.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(dir=root)
    try:
        reset_launches()
        with env_set(MESHFLOW_TRACE_DIR=tmp):
            stab._stabilize_frames(frames, 0, StageTimer(enabled=True, device=device))
        counted = counted_launches()
        stages, runs = {}, {}
        for stage, _ in stab.last_timer.stages:  # a trace a run: <stage>[.<k>].json
            k = runs[stage] = runs.get(stage, -1) + 1
            name = stage.replace(" ", "_") + (f".{k}" if k else "")
            with open(Path(tmp) / (name + ".json")) as fh:
                events = json.load(fh)["traceEvents"]
            names = [e.get("name") for e in events
                     if e.get("cat") in ("cuda_runtime", "cuda_driver")]
            kernels = [e.get("name") for e in events if e.get("cat") == "kernel"]
            row = stages.setdefault(stage, {"kernel_launches": 0, "graph_launches": 0,
                                            "copies": 0, "kernels": 0,
                                            "named": dict.fromkeys(KERNEL_NAMES, 0)})
            row["kernel_launches"] += sum(n in KERNEL_CALLS for n in names)
            row["graph_launches"] += names.count("cudaGraphLaunch")
            row["copies"] += names.count("cudaMemcpyAsync") + names.count("cudaMemsetAsync")
            row["kernels"] += len(kernels)
            for w, n in named_kernels(kernels).items():
                row["named"][w] += n
            del events, names, kernels
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    named = {w: sum(s["named"][w] for s in stages.values()) for w in KERNEL_NAMES}
    check(named == counted, f"traced {route} pass: the card ran {named} of the hand kernels, "
          f"the wrappers counted {counted}; by stage "
          f"{ {stage: s['named'] for stage, s in stages.items()} }")
    return stages


def online_traced(device, frames, warm: int = 12, traced: int = 8):
    """The online step graphed: `warm` frames (the graph captured at the
    third), then `traced` frames under ``torch.profiler`` (CUDA activity);
    the hand kernels the card ran, by name, against the wrappers' counts
    over those frames.  Returns the counts."""
    import torch

    from meshflow_tpu_torch.online import OnlineMeshFlowStabilizer

    stab = OnlineMeshFlowStabilizer(device=device)
    for frame in frames[:warm]:
        stab.process(frame)
    torch.cuda.synchronize()
    reset_launches()
    replays = stab._runner.replays
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for frame in frames[warm:warm + traced]:
            stab.process(frame)
        torch.cuda.synchronize()
    counted = counted_launches()
    named = named_kernels(e.name for e in prof.events())
    check(stab._runner.replays - replays == traced and stab._runner.captures == 1,
          f"graphs online traced: {stab._runner.replays - replays} replays of {traced} frames")
    check(named == counted, f"graphs online traced: the card ran {named} of the hand kernels "
          f"in {traced} replayed frames, the wrappers counted {counted}")
    stab.close()
    return named


def alternate(routes: dict, runs: int) -> dict:
    """`runs` rounds of each route's `run()` in turn (eager, graphed, eager,
    ...), every one warm: {route: [wall seconds]}."""
    walls = {route: [] for route in routes}
    for _ in range(runs):
        for route, run in routes.items():
            walls[route].append(timed_parallel(run)[1])
    return walls


def median(xs):
    return sorted(xs)[len(xs) // 2]


def phase_graphs(device, main, run_1080p, online, streamed, runs=2, online_frames=40):
    """The graphed units against the card run eagerly (``_graphs=False``)
    on the 640x360 main path, online, the 1080p d=3 path (kernel C) and
    the stream at CHUNK 64: the crop, every output frame and the three
    metrics torch.equal across the two routes, the launch counters equal.
    The graphed runs are the earlier phases' stabilizers, whose graphs are
    warm (no capture may happen in their passes here); the eager
    stabilizer of each path runs one untimed pass first (at 1080p, timed
    as its cold pass).  At 640x360 both routes' warm passes then alternate,
    `runs` rounds with their stages timed (a synchronize at each stage end;
    the caching allocator left as it is: no empty_cache between), their
    walls and peak device memory (allocated above the start and reserved:
    a graph's working set lives in its pool, reserved but not allocated
    while it replays).  For each route at 640x360, on the clip's first 64
    frames: CUDA launches and kernels by stage, the hand kernels counted by
    name and gated against the wrappers' counts (``trace_launches``), and
    the card's busy share (``kernel_share``); the graphed route's capture
    seconds and pool.  Online: the first `online_frames` frames eagerly,
    then graphed, against the online phase's frames, p50 / p90 and first
    frames, and the hand kernels of 8 replayed frames by name
    (``online_traced``).  The stream: each route's first run, then one
    round of warm runs."""
    import numpy as np
    import torch

    from meshflow_tpu_torch import streaming
    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.utils.profiling import StageTimer

    frames, ref = main["frames"], main["out"]
    want = dict(main["launches"], eig9=main["eig9"])
    stabs = {"eager": MeshFlowStabilizer(device=device, _graphs=False), "graphed": main["stab"]}
    before = runner_state(main["stab"])
    for route, stab in stabs.items():
        reset_launches()
        out = stab._stabilize_frames(frames, 0)
        launches = counted_launches()
        check(all(torch.equal(a, b) for a, b in zip(out, ref))
              and torch.equal(stab.last_crop, main["stab"].last_crop),
              f"graphs 640x360: {route} output differs from the main path's")
        check(launches == want, f"graphs 640x360: {route} launches {launches}, main path {want}")
        del out
    rows = {route: {"warm_s": [], "peak_allocated_gib": [], "peak_reserved_gib": []}
            for route in stabs}
    for _ in range(runs):
        for route, stab in stabs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            timer = StageTimer(enabled=True, device=device)
            _, wall = timed_parallel(lambda: stab._stabilize_frames(frames, 0, timer))
            row = rows[route]
            row["warm_s"].append(wall)
            row["stages"] = stage_seconds(timer)
            row["peak_allocated_gib"].append(
                (torch.cuda.max_memory_allocated() - base) / (1 << 30))
            row["peak_reserved_gib"].append(torch.cuda.max_memory_reserved() / (1 << 30))
    # both routes' stage traces before the whole-pass profiles: a stage
    # trace taken right after ``kernel_share``'s profile of a whole pass
    # missed kernel B's map kernel (H100, torch 2.11), one taken before did not
    traces = {route: trace_launches(stab, frames[:64], device, route)
              for route, stab in stabs.items()}
    for route, stab in stabs.items():
        wall, busy = kernel_share(device, lambda: stab._stabilize_frames(frames[:64], 0))
        traced = traces[route]
        total = {k: sum(t[k] for t in traced.values())
                 for k in ("kernel_launches", "graph_launches", "copies", "kernels")}
        row = rows[route]
        row.update(busy_share=busy / wall, busy_s=busy, traced_wall_s=wall,
                   launches_by_stage=traced,
                   launches_64_frames=total["kernel_launches"] + total["graph_launches"],
                   kernels_64_frames=total["kernels"], copies_64_frames=total["copies"],
                   median_warm_s=median(row["warm_s"]))
        print(f"graphs 640x360 {route}: outputs and launches equal to the main path's; warm "
              f"walls {[round(x, 4) for x in row['warm_s']]} s (alternating with the other "
              f"route, stages timed); stages (s) {row['stages']}; CUDA launches a pass of the "
              f"first 64 frames {row['launches_64_frames']} ({total['graph_launches']} graph "
              f"launches), kernels run {total['kernels']}, copies {total['copies']}; by stage "
              f"{traced}; hand kernels by name equal to the counters; card busy {busy:.3f} s "
              f"of {wall:.3f} s ({busy / wall:.4f}) in a pass of the first 64 frames; warm "
              f"pass peak device memory {[round(x, 3) for x in row['peak_allocated_gib']]} GiB "
              f"allocated above the start, {[round(x, 3) for x in row['peak_reserved_gib']]} "
              f"GiB reserved")
    captures = runner_state(main["stab"])[0] - before[0]
    check(captures == 0, f"graphs 640x360: {captures} captures in warm graphed passes")
    print(f"graphs 640x360 graphed: {main['captures']} captures in the main path's cold pass, "
          f"{main['capture_s']:.3f} s (each a capture and a replay), pool {main['pool_gib']} "
          f"GiB")

    rounds = {}
    for graphed in (False, True):
        route = "graphed" if graphed else "eager"
        got = phase_online(device, graphed=graphed, name=f"online {route}",
                           frames=online["frames"][:online_frames])
        check(all(np.array_equal(a, b) for a, b in zip(got["outs"], online["outs"])),
              f"graphs online: {route} frames differ from the online phase's")
        rounds[route] = got
    rows["online"] = {route: {k: run[k] for k in
                              ("first_ms", "second_ms", "third_ms", "p50_ms", "p90_ms")}
                      for route, run in rounds.items()}
    named = online_traced(device, online["frames"])
    rows["online"]["traced_named"] = named
    print(f"graphs online: the first {online_frames} frames torch.equal to the online phase's "
          f"on both routes, launches as counted there; {rows['online']}; 8 replayed frames "
          f"ran {named} of the hand kernels by name, as counted")

    with fetch_route("band"):
        stab = MeshFlowStabilizer(device=device, _graphs=False)
        reset_launches()
        out, cold = timed_parallel(lambda: stab._stabilize_frames(run_1080p["frames"], 0))
        launches = counted_launches()
        check(all(torch.equal(a, b) for a, b in zip(out, run_1080p["out"])),
              "graphs 1080p: eager output differs from the graphed one")
        check(launches == dict(run_1080p["launches"], eig9=run_1080p["eig9"]),
              f"graphs 1080p: eager launches {launches}, graphed {run_1080p['launches']}")
        del out, stab
    rows["1080p"] = {"eager_first_s": cold, "graphed_warm_s": run_1080p["warm_s"]}
    print(f"graphs 1080p d=3 (kernel C): torch.equal, launches equal ({launches}); eager first "
          f"pass {cold:.3f} s, graphed warm {run_1080p['warm_s']:.3f} s (1080p phase)")

    clip = streaming.ArrayClip(streamed["clip"])
    stream_stabs = {"eager": MeshFlowStabilizer(device=device, _graphs=False),
                    "graphed": MeshFlowStabilizer(device=device)}
    first = {}
    for route, stab in stream_stabs.items():
        got = run_streamed(stab, clip, device)
        first[route] = got + (eig9_launches(),)
    check_streamed("graphs stream", first["eager"], first["graphed"])
    want_eig9 = eig9_count(stream_stabs["eager"].config, len(streamed["clip"]), 64, streamed=True)
    check(first["eager"][3] == first["graphed"][3] and first["eager"][4] == first["graphed"][4]
          == want_eig9, f"graphs stream: launches {first['eager'][3:]} and "
          f"{first['graphed'][3:]}, eig9 reckoned {want_eig9}")
    walls = alternate({route: (lambda s=s: run_streamed(s, clip, device))
                       for route, s in stream_stabs.items()}, 1)
    stream_stabs["graphed"].close()
    rows["stream"] = {"first_s": {route: first[route][2] for route in first}, "warm_s": walls}
    print(f"graphs stream CHUNK 64: frames torch.equal, metrics and launches equal (eig9 "
          f"{want_eig9}); first runs {rows['stream']['first_s']} s (the graphed one captures); "
          f"warm walls alternating {walls}")
    return rows


# The 640x360 main path's digest (crop, cropping ratio, distortion,
# stability) while the DLT took its null vector from eigh on the card.
DIGEST_BEFORE_EIG9 = ([4, 4, 635, 355], (0.965138, 0.989568, 0.004488))
# NVIDIA's H100 SXM data sheet: float64 on the tensor cores (34 TFLOP/s
# outside them), the card's highest float64 rate.
H100_F64_FLOPS = 67e12
# Float64 operations the function needs for one 9x9 symmetric matrix,
# whatever the algorithm: its Householder reduction to tridiagonal form
# (4 n^3 / 3) and one eigenvector carried back through the reflectors
# (4 n^2); the tridiagonal eigenproblem's O(n) a step is left out, so the
# count is a floor.
EIG9_FUNCTION_OPS = 4 * 9**3 // 3 + 4 * 9**2


def eig9_bound(n: int):
    """(bound_ms, bound_by) of the least eigenvector of `n` 9x9 float64
    symmetric matrices: each matrix read once (81 doubles), its vector
    written once (9), ``EIG9_FUNCTION_OPS`` operations a matrix at the
    card's float64 peak."""
    t_ops, t_bytes = n * EIG9_FUNCTION_OPS / H100_F64_FLOPS, n * 90 * 8 / H100_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_eig9(device, main):
    """eig9 against eigh on the DLT inputs of one 63-pair motion block and
    one 64-frame metric block of the 640x360 clip, recorded as the eager
    route reaches ``dlt_homography`` (each call one launch: 256 point sets a
    batch's RANSAC fits, 16 its global fits).  Gates: where eigh's
    eigenvalue gap exceeds 1e-9 ||N||_F, the float32 homography within
    1e-5 relative of eigh's; everywhere v'Nv <= lambda_0 + 1e-12 ||N||_F
    and finite vectors; the kernel equal bit for bit to its PyTorch
    emulation (``null_vector_jacobi``); each batch's match with eig9 and
    with eigh giving the same ok, and the same inlier masks on the pairs
    whose global fit is degenerate.  Times at the RANSAC fit's launch (256
    matrices), the kernel's and eigh's taken the same two ways: device ms
    (``device_ms``: CUDA events around calls queued behind a spin kernel;
    eigh's host sync drains that queue at its first call, so its reading
    holds its sync) and host-clock ms per synchronized call; the bound from
    what the function needs (``eig9_bound``); the sweeps the matrices took
    (the emulation's count, the kernel being equal to it); whether the
    main path's digest moved."""
    import torch

    from meshflow_tpu_torch.kernels import eig9_cuda, homography
    from meshflow_tpu_torch.kernels.fast import Keypoints
    from meshflow_tpu_torch.metrics import quality
    from meshflow_tpu_torch.motion import features
    from meshflow_tpu_torch.motion import pipeline as mp
    from meshflow_tpu_torch.utils import prng

    stab, config = main["stab"], main["stab"].config
    frames = main["frames"][:64]
    recorded = []
    dlt = homography.dlt_homography

    def record(early, late, weights):
        recorded.append((early.clone(), late.clone(), weights.clone()))
        return dlt(early, late, weights)

    homography.dlt_homography = record
    try:
        kps, _ = mp.prepare_frames(frames, config)
        mp.pair_velocities(kps, frames, prng.fold_in(stab._key, 1), 0, config, 360, 640)
        cropped = main["out"][0][:64]
        quality.cropping_and_distortion(kps, frames, cropped, prng.fold_in(stab._key, 2), 0,
                                        config, 360, 640)
    finally:
        homography.dlt_homography = dlt
    check(len(recorded) == eig9_count(config, 64, 64), f"eig9: {len(recorded)} DLT calls")
    worst, max_err, degenerate, sweeps_all = 0.0, 0.0, 0, []
    for early, late, weights in recorded:
        normal, et, lt = homography.dlt_normal(early, late, weights)
        normal = normal.reshape(-1, 9, 9)
        vec = eig9_cuda.null_vector(normal)
        emu, sweeps = eig9_cuda.null_vector_jacobi(normal, return_sweeps=True)
        check(torch.equal(vec, emu), "eig9: the kernel differs from its emulation")
        w, vecs = torch.linalg.eigh(normal)
        fro = torch.linalg.matrix_norm(normal)
        rq = torch.einsum("bi,bij,bj->b", vec, normal, vec)
        check(bool(torch.isfinite(vec).all()) and bool((rq <= w[:, 0] + 1e-12 * fro).all()),
              "eig9: a vector is not finite or its Rayleigh quotient exceeds the gate")
        gapped = (w[:, 1] - w[:, 0]) > 1e-9 * fro
        degenerate += int((~gapped).sum())
        h = homography.dlt_from_null_vector(vec, et, lt).reshape(-1, 3, 3)
        h_eigh = homography.dlt_from_null_vector(vecs[..., 0], et, lt).reshape(-1, 3, 3)
        err = (h - h_eigh).abs().flatten(-2).amax(-1)
        if bool(gapped.any()):
            rel = (err / h_eigh.abs().flatten(-2).amax(-1))[gapped]
            worst = max(worst, float(rel.max()))
            max_err = max(max_err, float(err[gapped].max()))
        sweeps_all.append(sweeps)
    check(worst <= 1e-5, f"eig9: homographies {worst} relative off eigh's")
    sweeps = torch.cat(sweeps_all)

    late, tracked = mp.track_pairs(kps, frames, config, 360, 640)
    keys = prng.fold_in(prng.fold_in(stab._key, 1), torch.arange(16, device=device))
    batch = (kps.positions[:16], late[:16], tracked[:16], keys)
    with_eig9 = features.match_from_tracks(*batch, config)
    kernel = eig9_cuda.null_vector
    eig9_cuda.null_vector = eig9_cuda.null_vector_plain
    try:
        with_eigh = features.match_from_tracks(*batch, config)
    finally:
        eig9_cuda.null_vector = kernel
    normal = homography.dlt_normal(with_eigh.early, with_eigh.late,
                                   with_eigh.inlier.to(torch.float32))[0]
    w = torch.linalg.eigvalsh(normal)
    flat = (w[:, 1] - w[:, 0]) <= 1e-9 * torch.linalg.matrix_norm(normal)
    mask_diff = int((with_eig9.inlier != with_eigh.inlier).sum())
    check(torch.equal(with_eig9.ok, with_eigh.ok), "eig9: a batch's ok differs from eigh's")
    check(bool(torch.isfinite(with_eig9.homography).all()), "eig9: a homography is not finite")
    check(torch.equal(with_eig9.inlier[flat], with_eigh.inlier[flat]),
          "eig9: inlier masks differ from eigh's on a degenerate global fit")

    normal = homography.dlt_normal(*recorded[0])[0].reshape(-1, 9, 9)
    launch_sweeps = eig9_cuda.null_vector_jacobi(normal, return_sweeps=True)[1]
    ms = device_ms(lambda: eig9_cuda.null_vector(normal), launches=50)
    eigh_ms = device_ms(lambda: torch.linalg.eigh(normal), launches=50)
    host_ms = host_clock_ms(lambda: eig9_cuda.null_vector(normal))
    eigh_host_ms = host_clock_ms(lambda: torch.linalg.eigh(normal))
    bound_ms, bound_by = eig9_bound(normal.shape[0])
    crop, metrics = main["crop"], tuple(round(m, 6) for m in main["metrics"])
    moved = (crop, metrics) != DIGEST_BEFORE_EIG9
    print(f"eig9: {len(recorded)} launches' DLT inputs ({sweeps.numel()} matrices, "
          f"{degenerate} with eigh's gap <= 1e-9 ||N||_F) bit for bit its emulation; float32 "
          f"H within {worst:.3e} relative of eigh's (max abs {max_err:.3e}) where gapped; "
          f"Rayleigh gate held; sweeps mean {float(sweeps.float().mean()):.3f}, max "
          f"{int(sweeps.max())}; first motion batch: ok equal, {mask_diff} of "
          f"{with_eig9.inlier.numel()} inlier entries differ ({int(flat.sum())} degenerate "
          f"global fits, equal); at {normal.shape[0]} matrices "
          f"({launch_sweeps.float().mean():.3f} sweeps a matrix): device ms kernel {ms:.5f}, eigh {eigh_ms:.5f}; host-clock ms a "
          f"synchronized call kernel {host_ms:.5f}, eigh {eigh_host_ms:.5f}; bound "
          f"{bound_ms:.6f} ms ({bound_by}), the kernel at {ms / bound_ms:.0f}x it; 640x360 "
          f"digest {crop} {metrics} "
          f"{'moved from' if moved else 'unchanged from'} {DIGEST_BEFORE_EIG9}")
    return {"launches": main["eig9"], "max_abs_err": max_err, "ms": ms, "plain_ms": eigh_ms,
            "library_ms": eigh_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "host_ms": host_ms, "library_host_ms": eigh_host_ms,
            "max_rel_err": worst, "digest_moved": moved}


def halo_inputs(config, num_frames: int, device):
    """Seeded inputs of the halo Jacobi: (F, V_r, V_c, 2) displacement
    fields of `config`'s mesh (a random walk) and (F,) lambdas."""
    import numpy as np
    import torch

    rng = np.random.default_rng(1)
    shape = (num_frames, config.vertex_rows, config.vertex_cols, 2)
    du = torch.from_numpy(np.cumsum(rng.normal(0, 12.0, shape), axis=0).astype(np.float32))
    lambdas = torch.from_numpy(rng.uniform(0.5, 100.0, num_frames).astype(np.float32))
    return du.to(device), lambdas.to(device)


def phase_sharded_4k(device, num_frames=16, h=2160, w=3840, pan=36, solve_frames=3600):
    """The sharded path at the geometry of the JAX package's 4K smoke:
    ``stabilize_sharded`` on 3840x2160 x 16 frames over ["cuda:0"] (the
    calling process) and ["cuda:0"] * 2 (two worker processes, gloo;
    shards of 8 < omega take the replicated solve; no track geometry, as in
    JAX) within the shard-count gates, with each worker's peak device
    memory and the card's memory in use; then the halo Jacobi alone
    (``pipeline.smooth_sharded``) over 3600 frames of seeded displacement
    fields of the default mesh on 4 logical shards, four processes,
    torch.equal to the replicated ``jacobi_smooth``."""
    import numpy as np
    import torch

    from meshflow_tpu_torch.config import MeshFlowConfig
    from meshflow_tpu_torch.parallel import workers
    from meshflow_tpu_torch.parallel.pipeline import smooth_sharded, stabilize_sharded
    from meshflow_tpu_torch.solver.jacobi import jacobi_smooth
    from meshflow_tpu_torch.utils import prng

    config = MeshFlowConfig()
    frames = torch.from_numpy(synthetic_clip(num_frames, h, w, pan=pan)).to(device)
    key = prng.PRNGKey(SEED, device=device)
    levels = config.lk_max_level(h, w) + 1
    runs, out = {}, {}
    for shards, run in ((1, ""), (2, " cold"), (2, "")):
        devices = [device + ":0"] * shards
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with card_utilization() as smi, cpu_use() as cpu:
            res, wall = timed_parallel(lambda: stabilize_sharded(frames, key, config, h, w,
                                                                 devices=devices))
        launches = read_launches()
        procs = processes_of(devices)
        used = card_used_gib()
        peak = torch.cuda.max_memory_allocated() / (1 << 30)
        check(launches == {"lk_level": 2 * levels * shards, "lk_band": 0,
                           "backward_map": shards},
              f"sharded 4K {shards}: launches {launches}, expected kernel A "
              f"{2 * levels * shards}, kernel B {shards}")
        runs[f"{shards}{run}"] = (res[0], res[1].tolist(), tuple(float(x) for x in res[2:]))
        out[shards if not run else f"{shards}{run}"] = {
            "seconds": wall, "launches": launches, "card_used_gib": used, "peak_gib": peak,
            "smi_busy": smi.share, "cpu": cpu.by_process, **procs}
        del res
        print(f"sharded 4K {shards} shard(s){run}: {num_frames} frames {w}x{h}: {wall:.3f} s; "
              f"{procs['processes']} process(es), backend {procs['backend']}; peak device "
              f"memory {peak:.3f} GiB in this process, workers "
              f"{[round(x, 3) for x in procs['peak_gib']]} GiB, card in use {used:.3f} GiB, "
              f"busy (nvidia-smi) {smi.share}; CPU {cpu.line()}; "
              f"crop {runs[f'{shards}{run}'][1]}; metrics {runs[f'{shards}{run}'][2]}; "
              f"launches {launches}")
        if shards == 1:
            prof_wall, busy = kernel_share(devices[0], lambda: stabilize_sharded(
                frames, key, config, h, w, devices=devices))
            out[shards].update(profiled_seconds=prof_wall, kernel_seconds=busy)
            print(f"sharded 4K {shards} shard(s), profiled again: {prof_wall:.3f} s, kernels "
                  f"{busy:.3f} s, busy share of the card {busy / prof_wall:.4f}")
    # The 2-process call taken apart: the caller's copies, rank 0's stages
    # (the card synchronized between them), then rank 0's kernels traced
    # while rank 1 runs untraced.
    devices = [device + ":0"] * 2
    stages, staged = sharded_stages(devices, frames, key, config, h, w)
    check(torch.equal(staged[0], runs["2"][0]) and staged[1].tolist() == runs["2"][1],
          "sharded 4K: the staged 2-shard run differs from the plain one")
    traced, _ = sharded_stages(devices, frames, key, config, h, w, trace=True)
    out["stages"], out["rank 0 traced"] = stages, traced
    del staged
    workers.shutdown()
    print("sharded 4K 2 processes taken apart, seconds: " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + "; rank 0 traced while rank 1 runs "
        "untraced: " + ", ".join(f"{k} {v:.4f}" for k, v in traced.items()))
    check(torch.equal(runs["2"][0], runs["2 cold"][0]) and runs["2"][1:] == runs["2 cold"][1:],
          "sharded 4K: the warm 2-shard run differs from the cold one")
    rel, near = shard_count_gates("sharded 4K", runs["1"], runs["2"])
    print(f"sharded 4K: 2 shards against 1: crop equal, metric rel diffs {rel}, frames within "
          f"1 LSB on {near:.6f} of pixels")
    del runs, frames

    du, lambdas = halo_inputs(config, solve_frames, device)
    omega, iters = config.temporal_smoothing_radius, config.optimization_num_iterations
    times = {}
    replicated, times["replicated"] = timed_parallel(
        lambda: jacobi_smooth(du, lambdas, omega, iters))
    devices = [device + ":0"] * 4
    halo, times["halo cold"] = timed_parallel(
        lambda: smooth_sharded(du, lambdas, omega, iters, devices=devices))
    halo, times["halo"] = timed_parallel(
        lambda: smooth_sharded(du, lambdas, omega, iters, devices=devices))
    workers.shutdown()
    check(torch.equal(halo, replicated), "sharded 4K: the halo solve over "
          f"{solve_frames} frames differs from the replicated one by "
          f"{(halo - replicated).abs().max().item()} px")
    print(f"halo Jacobi: {solve_frames} frames of the {config.vertex_rows}x{config.vertex_cols} "
          f"vertex grid, 4 logical shards of {solve_frames // 4}, four processes: torch.equal "
          f"to the replicated solve; halo {times['halo']:.3f} s (cold {times['halo cold']:.3f}), "
          f"replicated {times['replicated']:.3f} s")
    return dict(out, solve_s=times)


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
# D copy and one-hot are held bit for bit at FINE_SIZES and at every
# rounds a launch from 1 to one past their ring of RING rounds in flight,
# and the probe's 50 (set in phase_probes); one-hot at its probe start and
# at starts whose rows run past the plane (300), start past it (320) and
# start before it (-5)
ONEHOT_STARTS = (300, 320, -5)
# G is held bit for bit at these feature counts
G_SIZES = (1, 8, 32)


def smi_query(field: str) -> str:
    """One field of ``nvidia-smi --query-gpu`` for the first card."""
    res = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0 and res.stdout.strip(), f"nvidia-smi gave no {field}")
    return res.stdout.strip().splitlines()[0]


def phase_probes(device):
    """The probe entry point (``python -m meshflow_tpu_torch.probes``) on
    the card with the six probe kernels' counts set to 0 before it and
    read after it; then, with launches of their own, each kernel against
    its plain version under the gates, all bit for bit: at the probes'
    sizes and at clamped and wrapped starts (F also on general float32
    values, in the entry point), D copy and one-hot at FINE_SIZES, 1 to
    RING + 1 and 50 rounds and ONEHOT_STARTS, D's fine select with a
    one-hot and a random selection matrix at FINE_SIZES and FINE_REPS, E
    at every start and ALIGNED_WIDTHS; then the marginal round of each D
    kernel at B = 16 against its floor."""
    import math

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

    # D copy and one-hot bit for bit: clamped and wrapped copy starts,
    # one-hot rows inside, past and before the plane, every rounds a launch
    # up to one past the ring and the probe's 50
    copy_reps = tuple(range(1, d.RING + 2)) + (d.REPS,)
    for b in FINE_SIZES:
        idx, plane = (t.to(device) for t in d.probe_inputs(b))
        starts = (int(idx[0]),) + ONEHOT_STARTS
        idx[:4] = torch.tensor([320, 640, -16, -100], dtype=torch.int32, device=device)
        for reps in copy_reps:
            got, want = d.dynslice_copy(idx, plane, reps), d.dynslice_copy_plain(idx, plane, reps)
            err["dynslice_copy"] = max(err["dynslice_copy"], entry.max_abs_err(got, want))
            check(all(torch.equal(x, y) for x, y in zip(got, want)),
                  f"dynslice_copy B={b} reps={reps} differs")
            for start in starts:
                first = idx.clone()
                first[0] = start
                got = d.onehot_rowsel(first, plane, reps)
                want = d.onehot_rowsel_plain(first, plane, reps)
                err["onehot_rowsel"] = max(err["onehot_rowsel"], entry.max_abs_err(got, want))
                check(all(torch.equal(x, y) for x, y in zip(got, want)),
                      f"onehot_rowsel B={b} idx[0]={start} reps={reps} differs")
        print(f"probe D copy and one-hot B={b}: equal to the plain versions at reps "
              f"{copy_reps}, one-hot idx[0] {starts}")
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
    # G at 1, 8 and 32 features, launched both ways, at the probe's
    # corners, bases past H - 16 (clamped) and negative ones (wrapped)
    plane, _ = (t.to(device) for t in g.probe_inputs())
    for b in G_SIZES:
        for kind, values in (
            ("probe", rng.integers(0, (g.H - g.ROWS) // 2, b)),
            ("past H - 16", rng.uniform(g.H / 2 - 8, g.H / 2 + 40, b)),
            ("negative", rng.uniform(-40.0, 0.0, b)),
        ):
            corners = g.corners_from(values).to(device)
            for pdl in (True, False):
                got = g.band_row(plane, corners, pdl=pdl)
                err["scalar_from_vmem"] = max(err["scalar_from_vmem"],
                                              entry.max_abs_err(got, g.band_row_plain(plane, corners)))
                check(torch.equal(got, g.band_row_plain(plane, corners)),
                      f"scalar_from_vmem B={b} {kind} corners pdl={pdl} differs")
    print(f"probe G: equal to the plain version at B {G_SIZES}, probe, clamped and wrapped "
          "bases, launched with and without programmatic dependent launch")
    # G's times: the kernel launched both ways, the launch floor of its grid
    # (an empty kernel launched the same way) and the library call (the
    # gather alone: index_select of precomputed rows), all in this process
    plane, corners = (t.to(device) for t in g.probe_inputs())
    index = torch.tensor([(math.floor(c * 2 + 1) // 8) * 8 for c in corners[:, 0].tolist()],
                         device=device)
    g_times = {}
    for pdl in (True, False):
        g_times[f"ms_pdl_{'on' if pdl else 'off'}"] = device_ms(
            lambda: g.band_row(plane, corners, pdl=pdl), launches=20)
        g_times[f"floor_ms_pdl_{'on' if pdl else 'off'}"] = device_ms(
            lambda: g.launch_floor(pdl=pdl), launches=20)
    g_times["index_select_ms"] = device_ms(lambda: plane.index_select(0, index), launches=20)
    print("probe G B=8 (ms a launch): " + ", ".join(f"{k} {v:.5f}" for k, v in g_times.items())
          + f"; default launch pdl={g.PDL}")

    # every round does its work: the marginal round of each D kernel at
    # the probe's B = 16 against the round's bytes over the card's
    # aggregate shared-memory rate (128 B an SM and clock at the top SM
    # clock), which a kernel that skipped rounds would beat
    name_power = smi_query("name,power.limit")
    mhz = float(smi_query("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    smem_rate = sms * 128 * mhz * 1e6  # bytes/s
    idx, plane = (t.to(device) for t in d.probe_inputs(16))
    rsel = d.one_hot_rsel(16).to(device)
    # the bytes a round fetches on chip: 16 bands of 48 x 256, or 16 x 40 rows
    band, rows = 4 * 16 * d.BAND_R * d.BAND_C, 4 * 16 * d.PN * plane.shape[1]
    marginal = {}
    for name, fn, nbytes in (
        ("dynslice_copy", lambda n: d.dynslice_copy(idx, plane, n), band),
        ("dynslice_fine", lambda n: d.dynslice_fine(idx, plane, rsel, n), band),
        ("onehot_rowsel", lambda n: d.onehot_rowsel(idx, plane, n), rows),
    ):
        one = device_ms(lambda: fn(1), launches=20)
        many = device_ms(lambda: fn(d.REPS), launches=20)
        ms = (many - one) / (d.REPS - 1)
        floor_ms = nbytes / smem_rate * 1e3
        marginal[name] = {"marginal_round_ms": ms, "round_bytes": nbytes,
                          "marginal_round_tb_s": nbytes / ms * 1e-9}
        print(f"probe {name} B=16 marginal round: ({many:.5f} - {one:.5f}) / {d.REPS - 1} = "
              f"{ms * 1e3:.4f} us for {nbytes} B, {nbytes / ms * 1e-9:.3f} TB/s; floor "
              f"{floor_ms * 1e3:.4f} us ({sms} SMs x 128 B x {mhz:.0f} MHz = "
              f"{smem_rate * 1e-12:.2f} TB/s; {name_power})")
        check(ms >= floor_ms, f"{name}: marginal round {ms} ms below the floor {floor_ms} ms "
                              "of the shared-memory rate: rounds are skipped")

    out = {}
    for name, (_, case, replaces) in PROBE_KERNELS.items():
        rows = [r for r in results if r["kernel"] == name]
        for r in rows:
            bms, by = probe_bound(name, r["case"])
            library = "none" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms"
            per_round = (f" ({r['ms'] / d.REPS:.6f} ms per round)"
                         if name in ("dynslice_copy", "dynslice_fine", "onehot_rowsel") else "")
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
        if name == "scalar_from_vmem":
            out[name].update(g_times)
        out[name].update(marginal.get(name, {}))
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


TREE_PARTS = ("lk", "bmap", "main", "probes", "batch", "sharded", "online")
# "batch" and "sharded" need a tree whose parallel paths run worker
# processes (``parallel.pipeline.smooth_sharded``), "online" is host-bound
# and long: asked for by name
DEFAULT_PARTS = TREE_PARTS[:4]
# The probe D launches that the "probes" part times, (kernel, B); probe E
# is timed at the probe's r0
TREE_PROBES = (("copy", 16), ("copy", 64), ("copy", 128), ("fine", 16), ("fine", 64),
               ("fine", 128), ("onehot", 16))


def probe_tree_times(kernel_ms):
    """The "probes" part of `tree_run`: device ms per launch of D copy, D
    fine and D one-hot at TREE_PROBES (at B = 16 also at one round a
    launch, "reps=1") and of E at the probe's r0, beside the library calls
    of the same function (D copy: 50 index gathers; D fine: 50 bmm alone
    and 50 x (band gather + bmm); D one-hot: 50 index_select; E: slice +
    clone), and of G at the probe's B = 8 beside its library call (one
    index_select of the precomputed rows) and, in a tree that has them, its
    times launched without programmatic dependent launch and its launch
    floor; returns a digest of every timed kernel's outputs."""
    import torch

    from meshflow_tpu_torch.probes import (
        aligned_dynslice as e,
        dynslice_fetch as d,
        scalar_from_vmem as g,
    )

    outputs = []
    for kind, b in TREE_PROBES:
        idx, plane = (t.to("cuda") for t in d.probe_inputs(b))
        args = (idx, plane)
        if kind == "fine":
            args += (d.one_hot_rsel(b).to("cuda"),)
        fn = d.onehot_rowsel if kind == "onehot" else getattr(d, f"dynslice_{kind}")
        outputs += fn(*args)
        kernel_ms[f"D {kind} B={b}"] = device_ms(lambda: fn(*args), launches=20)
        if b == 16:
            kernel_ms[f"D {kind} B={b} reps=1"] = device_ms(lambda: fn(*args, 1), launches=20)
        if kind == "copy":
            index = [d.band_index(idx, r, *plane.shape) for r in range(d.REPS)]
            kernel_ms[f"D copy B={b} library gathers"] = device_ms(
                lambda: [plane[i] for i in index], launches=20)
        if kind == "onehot":
            k = torch.arange(b * d.PN, device="cuda") % d.PN
            rows = [idx[0].long() + r % 4 + k for r in range(d.REPS)]
            kernel_ms[f"D onehot B={b} library index_select"] = device_ms(
                lambda: [plane.index_select(0, r) for r in rows], launches=20)
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
    # G at the probe's B = 8 (and, in a tree that has them, launched without
    # programmatic dependent launch, and the launch floor of its grid)
    plane, corners = (t.to("cuda") for t in g.probe_inputs())
    outputs.append(g.band_row(plane, corners))
    kernel_ms["G B=8"] = device_ms(lambda: g.band_row(plane, corners), launches=20)
    if hasattr(g, "launch_floor"):
        for pdl in (True, False):
            tag = "on" if pdl else "off"
            kernel_ms[f"G B=8 pdl={tag}"] = device_ms(
                lambda: g.band_row(plane, corners, pdl=pdl), launches=20)
            kernel_ms[f"G floor pdl={tag}"] = device_ms(
                lambda: g.launch_floor(pdl=pdl), launches=20)
    index = g.band_row_plain(torch.arange(g.H, dtype=torch.float32, device="cuda")[:, None]
                             .expand(g.H, 4).contiguous(), corners)[:, 0, 0].long()
    kernel_ms["G library index_select"] = device_ms(
        lambda: plane.index_select(0, index), launches=20)
    return digest(*outputs)


def tree_run(tree: Path, parts=DEFAULT_PARTS, warm_passes: int = 3) -> int:
    """The `parts` of a tree's run, with the package imported from the
    checkout in `tree`; prints one JSON line.  "lk": kernel A on step 3's
    inputs (digest), the device ms per launch of kernel A at every
    `lk_cases` case, of kernel A's set-up alone (``max_iters=0``, "A0") and
    of kernel C at the 8-pair and motion cases, kernel A's launch shape
    (the tree's ``lk_cuda.occupancy()``).  "bmap": kernel B's outputs at
    every BMAP_CASES case (digest), device ms and host-clock ms per call at
    the timed cases.  "main": the 640x360 main path's output digest, crop,
    metrics and wall times.  "probes": `probe_tree_times`.  "batch":
    ``stabilize_batch`` of two 640x360 x 120-frame clips on two worker
    processes of the card, a cold and `warm_passes` warm walls, and a
    digest of the last call's frames and metrics.  "sharded":
    ``stabilize_sharded`` on 3840x2160 x 16 frames over two worker
    processes of the card and the halo Jacobi over 3600 frames on four
    (``smooth_sharded``), a cold and `warm_passes` warm walls each, and a
    digest of their outputs.  "online": ``OnlineMeshFlowStabilizer`` over
    the 120-frame 640x360 clip, p50 and p90 of frames 10-119 and a digest
    of its frames.  In a tree whose stabilizers take ``_graphs``, "main"
    and "online" run the card eagerly too (``main_eager``,
    ``online_eager``), after the graphed run.  Always the ptxas lines of the tree's LK,
    backward-map and D and E probe kernels (when its build keeps them)."""
    sys.path.insert(0, str(tree))
    import torch

    import meshflow_tpu_torch
    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.kernels import _build, bmap_cuda, lk_cuda

    result = {"package": str(Path(meshflow_tpu_torch.__file__).parent),
              "ptxas": ptxas_report(_build.build()["log"], "lk_", "map_kernel", "table_kernel",
                                   "dynslice", "onehot", "aligned"),
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
    if "batch" in parts:
        from meshflow_tpu_torch import streaming
        from meshflow_tpu_torch.parallel import workers
        from meshflow_tpu_torch.parallel.batch import BatchJob, stabilize_batch

        clips = [synthetic_clip(120, 360, 640, pan=60 + 30 * i) for i in range(2)]
        walls = result.setdefault("batch_s", [])
        for _ in range(1 + warm_passes):
            jobs = [BatchJob(streaming.ArrayClip(f), streaming.CaptureWriter(), 0) for f in clips]
            metrics, wall = timed_parallel(lambda: stabilize_batch(jobs, devices=["cuda:0"] * 2))
            walls.append(wall)
        workers.shutdown()
        result["batch"] = digest(*(torch.from_numpy(j.output_path.frames()) for j in jobs),
                                 torch.tensor(metrics))
    if "sharded" in parts:
        from meshflow_tpu_torch.config import MeshFlowConfig
        from meshflow_tpu_torch.parallel import workers
        from meshflow_tpu_torch.parallel.pipeline import smooth_sharded, stabilize_sharded
        from meshflow_tpu_torch.utils import prng

        config = MeshFlowConfig()
        frames = torch.from_numpy(synthetic_clip(16, 2160, 3840, pan=36)).to("cuda")
        key = prng.PRNGKey(SEED, device="cuda")
        du, lambdas = halo_inputs(config, 3600, "cuda")
        omega, iters = config.temporal_smoothing_radius, config.optimization_num_iterations
        walls, outputs = result.setdefault("sharded_s", {}), []
        for name, run in (
            ("4K x 16, 2 processes", lambda: stabilize_sharded(
                frames, key, config, 2160, 3840, devices=["cuda:0"] * 2)),
            ("halo Jacobi 3600 frames, 4 processes", lambda: (smooth_sharded(
                du, lambdas, omega, iters, devices=["cuda:0"] * 4),)),
        ):
            for _ in range(1 + warm_passes):
                got, wall = timed_parallel(run)
                walls.setdefault(name, []).append(wall)
            outputs += list(got[:2])
            workers.shutdown()
        result["sharded"] = digest(*outputs)
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
        if "_graphs" in inspect.signature(MeshFlowStabilizer).parameters:
            del stab
            stab = MeshFlowStabilizer(device="cuda", _graphs=False)
            seconds = [timed_parallel(lambda: stab._stabilize_frames(frames, 0))[1]
                       for _ in range(1 + warm_passes)]
            result["main_eager"] = {"cold_s": seconds[0], "warm_s": seconds[1:]}
    if "online" in parts:
        import numpy as np

        from meshflow_tpu_torch.online import OnlineMeshFlowStabilizer

        frames = synthetic_clip(120, 360, 640, pan=60)
        routes = {"online": {}}
        if "_graphs" in inspect.signature(OnlineMeshFlowStabilizer).parameters:
            routes["online_eager"] = {"_graphs": False}
        for name, kwargs in routes.items():
            stab = OnlineMeshFlowStabilizer(device="cuda", **kwargs)
            times, outs = [], []
            for frame in frames:
                out, wall = timed_parallel(lambda: stab.process(frame))
                times.append(wall * 1e3)
                outs.append(out)
            steady = np.asarray(times[10:])
            result[name] = {"p50_ms": float(np.percentile(steady, 50)),
                            "p90_ms": float(np.percentile(steady, 90)),
                            "first_ms": times[:3],
                            "digest": digest(*(torch.from_numpy(o) for o in outs))}
            del stab
    print(json.dumps(result))
    return 0


def compare_trees(other: Path, here: Path, parts=DEFAULT_PARTS) -> int:
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
    for key in ("kernel_a", "bmap", "main_path", "probes", "batch", "sharded"):
        if key in runs[0]:
            check(len({r[key] for r in runs}) == 1, f"the trees' {key} outputs differ")
    warm, times, parallel = {}, {"kernel_ms": {}, "host_ms": {}}, {}
    for r in runs:
        warm.setdefault(r["tree"], []).extend(r.get("warm_s", []))
        for name, walls in r.get("sharded_s", {}).items():
            parallel.setdefault(r["tree"], {}).setdefault(name, []).append(walls)
        if "batch_s" in r:
            parallel.setdefault(r["tree"], {}).setdefault("batch, 2 processes", []).append(
                r["batch_s"])
        for kind, per_tree in times.items():
            for name, ms in r[kind].items():
                per_tree.setdefault(r["tree"], {}).setdefault(name, []).append(ms)
    print(json.dumps({"same_outputs": True, "warm_s": warm,
                      "median_warm_s": {t: sorted(v)[len(v) // 2] for t, v in warm.items() if v},
                      "kernel_ms_per_launch": times["kernel_ms"],
                      "host_ms_per_call": times["host_ms"],
                      "parallel_cold_and_warm_s": parallel}))
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
    parser.add_argument("--tree", metavar="DIR", type=Path,
                        help="run the parts of the checkout in DIR alone and print their "
                             "JSON line (no comparison: for trees whose outputs differ)")
    parser.add_argument("--parts", default=",".join(DEFAULT_PARTS),
                        help="with --compare or --tree: the parts to run, of "
                             f"{', '.join(TREE_PARTS)} (default: {', '.join(DEFAULT_PARTS)})")
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

    print(smi_query("name,power.limit"))
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

    from meshflow_tpu_torch.config import MeshFlowConfig

    device = "cuda"
    os.environ.pop("MESHFLOW_LK_FETCH", None)  # the default route, onehot
    clock = [time.perf_counter(), time.perf_counter()]

    def lap(name):
        """Print the phase's seconds and the script's so far."""
        now = time.perf_counter()
        print(f"time: {name} {now - clock[1]:.1f} s (script {now - clock[0]:.1f} s)", flush=True)
        clock[1] = now

    cases = lk_cases(device)
    a = phase_kernel_a(device, cases)
    lap("kernel_a")
    b = phase_kernel_b(device)
    lap("kernel_b")
    render = phase_render_kernels(device)
    lap("render_kernels")
    c = phase_kernel_c(device, cases["motion"])
    lap("kernel_c")
    g = phase_gray_kernels(device)
    lap("gray_kernels")
    launches, cold_s, warm_s, main_out, main_run = phase_main_path(device)
    lap("main_path")
    launches_1080p, first_block, warm_1080p_s, stages_1080p, run_1080p = phase_1080p(device)
    lap("1080p")
    phase_1080p_control(device, first_block, pan=360 * (64 - 1) / (300 - 1))
    lap("1080p_control")
    online = phase_online(device)
    lap("online")
    phase_small_agreement(device)
    lap("small_agreement")
    native_ok = phase_native_io()
    lap("native_io")
    streamed = phase_streamed(device)
    lap("streamed")
    graphed = phase_graphs(device, main_run, run_1080p, online, streamed)
    lap("graphs")
    del run_1080p, first_block
    eig9 = phase_eig9(device, main_run)
    lap("eig9")
    phase_checkpoint(device, streamed)
    lap("checkpoint")
    memory = phase_memory(device)
    lap("memory")
    gray = phase_gray(device, (launches, cold_s, warm_s), warm_1080p_s, memory, online)
    lap("gray")
    sk = phase_sharded_kernels(device)
    lap("sharded_kernels")
    sharded = phase_sharded(device)
    lap("sharded")
    batch = phase_batch(device)
    lap("batch")
    gk = phase_geometry_kernels(device)
    lap("geometry_kernels")
    uhd = phase_4k(device)
    lap("4k")
    mesh64 = phase_mesh64(device, stages_1080p)
    lap("mesh64")
    hd = phase_geometry(device, "720p", MeshFlowConfig(), 300, 720, 1280, pan=240)
    lap("geometry")
    serving = phase_serving(device, main_out, (cold_s, warm_s))
    lap("serving")
    del main_out
    sharded_4k = phase_sharded_4k(device)
    lap("sharded_4k")
    phase_file(device, native_ok)
    lap("file")
    probes = phase_probes(device)
    lap("probes")

    def geometry_launches(name):
        return {"launches_4k": uhd["launches"][name],
                "launches_4k_streamed": uhd["streamed"]["default"]["launches"][name],
                "launches_4k_serving": uhd["serving"]["launches"][name],
                "launches_serving": serving["launches"][name],
                "launches_mesh64": mesh64["launches"][name],
                "launches_mesh64_streamed": mesh64["streamed"]["launches"][name],
                "launches_720p": hd["launches"][name],
                "launches_sharded_4k": sharded_4k[2]["launches"][name]}

    def geometry_row(kernel, suffix):
        return {f"{k}_{suffix}": gk[kernel][k]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}

    def path_launches(name):
        return {"launches_gray": gray["main"]["launches"][name],
                "launches_gray_online": gray["online"]["launches"][name],
                "launches_sharded": sharded["4 shards"]["launches"][name],
                "launches_batch": batch[2]["launches"][name]}

    gray_a = {f"{k}_gray": g["motion"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    gray_a.update(ms_gray_metric=g["metric"]["ms"], ms_gray_online=g["online"]["ms"],
                  warps_per_sm_gray=g["occupancy"][0])
    sharded_a = {f"{k}_sharded": sk["motion"][k]
                 for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    sharded_a.update(ms_sharded_metric=sk["metric"]["ms"],
                     bound_ms_sharded_metric=sk["metric"]["bound_ms"],
                     ms_sharded_1_shard=sk["motion 1 shard"]["ms"],
                     bound_ms_sharded_1_shard=sk["motion 1 shard"]["bound_ms"],
                     max_abs_err_sharded=sk["max_abs_err"])
    sharded_b = {f"{k}_sharded": sk["bmap 4 shards"][k]
                 for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    sharded_b.update({f"{k}_sharded_1_shard": sk["bmap 1 shard"][k]
                      for k in ("ms", "plain_ms", "bound_ms")},
                     max_abs_err_sharded=sk["bmap_max_abs_err"])

    kernels = [
        {"name": "lk_level", "route": "cuda",
         "source": "meshflow_tpu_torch/csrc/lk_level.cu",
         "replaces": "meshflow_tpu/kernels/_lk_pallas_onehot.py:73",
         "launches": launches["lk_level"],
         "launches_streamed": streamed["launches"]["lk_level"],
         **path_launches("lk_level"),
         **{k: a[k] for k in LK_KEYS + ("ms_metric", "ms_online", "warps_per_sm", "regs")},
         **gray_a, "max_abs_err_gray": g["max_abs_err"], **sharded_a,
         **geometry_launches("lk_level"), **geometry_row("A", "4k"),
         **geometry_row("A 4K metric", "4k_metric"),
         **geometry_row("A sharded 4K motion", "sharded_4k"),
         **geometry_row("A sharded 4K metric", "sharded_4k_metric")},
        {"name": "backward_map", "route": "cuda",
         "source": "meshflow_tpu_torch/csrc/bmap.cu",
         "replaces": "meshflow_tpu/kernels/bmap_pallas.py:90",
         "launches": launches["backward_map"],
         "launches_streamed": streamed["launches"]["backward_map"],
         **path_launches("backward_map"),
         "launches_gray_1080p": gray["1080p"]["launches"]["backward_map"], **b, **sharded_b,
         **geometry_launches("backward_map"), **geometry_row("B 4K", "4k"),
         **geometry_row("B 1080p/64 block", "1080p_mesh64_block")},
        {"name": "lk_band", "route": "cuda",
         "source": "meshflow_tpu_torch/csrc/lk_band.cu",
         "replaces": "meshflow_tpu/kernels/_lk_pallas_band.py:89",
         "launches": launches_1080p["lk_band"],
         "launches_streamed_1080p": memory["launches"]["lk_band"],
         "launches_gray_1080p": gray["1080p"]["launches"]["lk_band"],
         **{k: c[k] for k in LK_KEYS},
         **{f"{k}_gray": g["band"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
         **geometry_row("C", "4k")},
        {"name": "eig9", "route": "cuda",
         "source": "meshflow_tpu_torch/csrc/eig9.cu",
         "replaces": "no TPU kernel: torch.linalg.eigh in meshflow_tpu_torch/kernels/"
                     "homography.py dlt_homography (the JAX package's float32 SVD, "
                     "meshflow_tpu/kernels/homography.py:74)",
         "launches_online": online["eig9"], "max_rel_err": eig9.pop("max_rel_err"),
         "digest_moved": eig9.pop("digest_moved"), **eig9},
    ] + [
        {"name": f"render_{kernel}", "route": "cuda", "source": "meshflow_tpu_torch/csrc/render.cu",
         "replaces": "no TPU kernel: the JAX package's XLA-fused warp and crop-stretch "
                     "(meshflow_tpu/render/stabilize.py)",
         "launch_shape": {c: v for c, v in render["shape"].items() if c.startswith(kernel)},
         **{case: rows[kernel] for case, rows in render.items() if case != "shape"}}
        for kernel in ("warp", "crop")
    ] + [
        {"name": name, "route": "cuda",
         "source": f"meshflow_tpu_torch/csrc/{PROBE_KERNELS[name][0]}", **row}
        for name, row in probes.items()
    ]
    print(json.dumps({"graphs": graphed}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
