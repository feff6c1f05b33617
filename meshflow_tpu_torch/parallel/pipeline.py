"""Frame-sharded stabilization: the port of
``meshflow_tpu/parallel/pipeline.py``.

The JAX package runs one ``shard_map``ped, jitted step over a 1-D device
mesh.  The port runs the same step, ``shard_step``, once a rank: one
process a device entry (``workers.pool``), with a ``torch.distributed``
group over them (NCCL when the entries are distinct cards, gloo when they
repeat or lie on the CPU), and its collectives through
``workers.Collectives``:

* ppermute on the ring: the one-frame halo that lets every shard match
  its boundary pair, and the previous shard's last displacement;
* a neighbour exchange (``halo``): the halo Jacobi's omega-frame halos,
  both directions in one batch a sweep (``solver/jacobi.jacobi_smooth_halo``);
* all_gather: the shard totals of the distributed prefix sum, the
  homographies for the adaptive weights, the solved state for the
  stability score, the shards' crops (intersected: JAX's pmax / pmin) and
  the metrics (JAX's pmean / pmin, reduced in rank order on every rank,
  so that no bit depends on the backend's reduction order).

The parent puts the clip once into shared host memory; each rank uploads
its block and writes its cropped block into a shared host output, which
the parent returns on the first entry's device.  One entry runs in the
calling process, with no group.

As in the JAX package, the sharded path tracks BGR frames at full
resolution (no track geometry, no gray planes), and frame pairs draw
their RANSAC keys from fold_in(key, global pair) on the raw key.
"""

from __future__ import annotations

import torch

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels.fast import Keypoints
from meshflow_tpu_torch.metrics.quality import cropping_and_distortion, stability_score
from meshflow_tpu_torch.motion.pipeline import pair_velocities, prepare_frames
from meshflow_tpu_torch.parallel import device_list, workers
from meshflow_tpu_torch.render.stabilize import crop_frames, intersect_crops, render_stabilized
from meshflow_tpu_torch.solver.jacobi import jacobi_smooth, jacobi_smooth_halo
from meshflow_tpu_torch.solver.weights import adaptive_weights
from meshflow_tpu_torch.utils import graphs, grid, prng

SOLVER_MODES = ("halo", "replicated")


def shard_step(frames_local, key, config: MeshFlowConfig, frame_height: int, frame_width: int,
               num_frames: int, adaptive_weights_definition: int, solver_mode: str,
               comm: workers.Collectives, runner: graphs.GraphRunner | None = None):
    """One rank's part of the sharded step (the JAX package's ``step``):
    frames_local its (B, H, W, 3) uint8 block on its device; its match
    batches run through `runner` (None: directly).  Returns
    (cropped block, crop (4,), cropping_ratio, distortion_score,
    stability_score), the last four the same on every rank."""
    rank, num_shards, device = comm.rank, comm.world, frames_local.device
    block = frames_local.shape[0]
    h, w = frame_height, frame_width

    # --- halo: receive the next shard's first frame -----------------------
    frames_ext = torch.cat([frames_local, comm.ppermute(frames_local[:1], 1)])
    keypoints, _ = prepare_frames(frames_ext, config)

    # --- local pair motion (B pairs; the global wrap pair is masked) ------
    vel, homo, _ = pair_velocities(keypoints, frames_ext, key, rank * block, config, h, w,
                                   runner)
    valid = rank * block + torch.arange(block, device=device) < num_frames - 1
    vel = torch.where(valid[:, None, None, None], vel, torch.zeros_like(vel))
    eye = torch.eye(3, dtype=homo.dtype, device=device).expand_as(homo)
    homo = torch.where(valid[:, None, None], homo, eye)

    # --- distributed displacement prefix sum ------------------------------
    local_cum = torch.cumsum(vel, dim=0)
    totals = comm.all_gather(local_cum[-1])
    before = (torch.arange(num_shards, device=device) < rank)[:, None, None, None]
    prefix = torch.where(before, totals, torch.zeros_like(totals)).sum(0)
    disp_pairs = local_cum + prefix  # displacements of frames t+1

    # --- adaptive weights need every pair homography (tiny) ---------------
    homos_full = comm.all_gather(homo).reshape(num_frames, 3, 3)
    lambdas = adaptive_weights(homos_full, w, h, adaptive_weights_definition)

    omega, iterations = config.temporal_smoothing_radius, config.optimization_num_iterations
    if solver_mode == "halo":
        # Shift the displacements one frame right across shards: frame iB
        # takes the left neighbour's last prefix (zero on the first shard).
        prev_tail = comm.ppermute(disp_pairs[-1:], -1)
        if rank == 0:
            prev_tail = torch.zeros_like(prev_tail)
        du_local = torch.cat([prev_tail, disp_pairs[:-1]])
        ds_local = jacobi_smooth_halo(du_local, lambdas, omega, iterations, comm)
        stab_full = comm.all_gather(ds_local).flatten(0, 1)
    else:
        # replicate the tiny temporal state and solve it on every rank
        disp_tail = comm.all_gather(disp_pairs).flatten(0, 1)
        disp_full = torch.cat([torch.zeros_like(disp_tail[:1]), disp_tail[: num_frames - 1]])
        stab_full = jacobi_smooth(disp_full, lambdas, omega, iterations)
        du_local = disp_full[rank * block : (rank + 1) * block]
        ds_local = stab_full[rank * block : (rank + 1) * block]

    # --- render; the crop intersects the shards' crops --------------------
    unstab_grid = grid.vertex_grid(config, h, w, device=device)
    stabilized, crop_local = render_stabilized(frames_local, du_local, ds_local, unstab_grid,
                                               config, h, w)
    crop = intersect_crops(comm.all_gather(crop_local))
    cropped = crop_frames(stabilized, crop, h, w)
    del stabilized

    # --- metrics: the mean of the shard means, the min of the mins -------
    if config.compute_metrics:
        ratios, distortions = cropping_and_distortion(
            Keypoints(*(a[:block] for a in keypoints)), frames_local, cropped,
            prng.fold_in(key, 10_000), rank * block, config, h, w, runner,
        )
        cropping_ratio = comm.all_gather(ratios.mean()).mean()
        distortion_score = comm.all_gather(distortions.amin()).amin()
    else:
        cropping_ratio = distortion_score = torch.tensor(float("nan"), device=device)

    # stability from the gathered solve (the same on every rank)
    return cropped, crop, cropping_ratio, distortion_score, stability_score(stab_full)


def _over_ranks(devices, rank_fn, x, *args):
    """rank_fn(rank, world, x, out, *args) on one worker process a device,
    over their group, with `x` and an output of its shape and dtype in
    shared host memory (the pool's buffers, kept for the next call of this
    shape); returns (a copy of out on the first device, every rank's
    result)."""
    pool = workers.pool(devices)
    pool.init_group()
    shared = pool.shared("in", x.shape, x.dtype)
    shared.copy_(x)
    out = pool.shared("out", x.shape, x.dtype)
    world = len(devices)
    results = pool.each(rank_fn, [(r, world, shared, out) + args for r in range(world)])
    return out.to(devices[0], copy=True), results


def _graphed_step(frames_local, key, config, h, w, num_frames, awd, solver_mode, comm):
    """``shard_step`` with its match batches as CUDA graphs of a runner of
    the call's own, cleared when the step returns."""
    runner = graphs.GraphRunner()
    try:
        return shard_step(frames_local, key, config, h, w, num_frames, awd, solver_mode, comm,
                          runner)
    finally:
        runner.clear()


def _shard_rank(rank, world, frames, out, key, config, h, w, awd, solver_mode):
    """A worker's rank: upload its block of the shared clip, run
    ``shard_step``, write its cropped block into the shared output; returns
    the rest on the host."""
    device = workers.device()
    block = frames.shape[0] // world
    rows = slice(rank * block, (rank + 1) * block)
    got = _graphed_step(frames[rows].to(device), key.to(device), config, h, w, frames.shape[0],
                        awd, solver_mode, workers.Collectives(rank, world, device))
    out[rows].copy_(got[0])
    return tuple(x.cpu() for x in got[1:])


def stabilize_sharded(
    frames: torch.Tensor,
    key: torch.Tensor,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
    devices=None,
    adaptive_weights_definition: int = 0,
    solver_mode: str = "halo",
):
    """Stabilize a clip with its frames sharded over `devices`, one process
    a shard.

    frames: (F, H, W, 3) uint8 BGR on any device, F divisible by the
    number of shards; key: a port key (``utils.prng.PRNGKey``); devices:
    one torch device per shard, which may repeat (default: every CUDA
    device).  Returns (cropped (F, H, W, 3) uint8, crop (4,),
    cropping_ratio, distortion_score, stability_score), all on the first
    shard's device.

    solver_mode: "halo" keeps the (F, V, 2) solver state sharded and
    exchanges an omega-frame halo per Jacobi sweep, bit-identical to
    "replicated", which gathers the state and solves it whole; shards
    shorter than omega take "replicated".  In serving mode
    (config.compute_metrics off) the cropping ratio and distortion are NaN.

    With two or more entries the worker processes (``workers.pool``) stay
    up after the call, for the next call with the same list, together
    with two host buffers of the clip's size in shared memory; a call with
    another list, or ``workers.shutdown()``, ends them.  Between calls each
    holds its CUDA context on its card and no other device memory.

    On the card each rank's motion and metric batches (``shard_step``) run
    as CUDA graphs of a runner that lives for the call: a batch shape is
    captured at its second batch and replayed after, and the graphs and
    their pool (2.06 GiB a rank on the 16x16 mesh at 640x360, H100 80GB
    HBM3 at 700 W) are freed when the rank's step returns.
    """
    if solver_mode not in SOLVER_MODES:
        raise ValueError(f"solver_mode {solver_mode!r}: expected one of {SOLVER_MODES}")
    devices = device_list(devices)
    num_shards, num_frames = len(devices), frames.shape[0]
    if num_frames % num_shards:
        raise ValueError(f"{num_frames} frames do not split over {num_shards} shards")
    if num_frames // num_shards < config.temporal_smoothing_radius:
        solver_mode = "replicated"  # the halo reaches one neighbour only
    first = devices[0]
    if num_shards == 1:
        return _graphed_step(frames.to(first), key.to(first), config, frame_height,
                             frame_width, num_frames, adaptive_weights_definition, solver_mode,
                             workers.Collectives(0, 1, first))
    out, results = _over_ranks(devices, _shard_rank, frames, key.cpu(), config, frame_height,
                               frame_width, adaptive_weights_definition, solver_mode)
    return (out,) + tuple(x.to(first) for x in results[0])


def _smooth_rank(rank, world, b, out, lambdas, omega, iterations):
    device = workers.device()
    block = b.shape[0] // world
    rows = slice(rank * block, (rank + 1) * block)
    out[rows].copy_(jacobi_smooth_halo(b[rows].to(device), lambdas.to(device), omega,
                                       iterations, workers.Collectives(rank, world, device)))


def smooth_sharded(b: torch.Tensor, lambdas: torch.Tensor, omega: int, iterations: int,
                   devices=None) -> torch.Tensor:
    """The halo Jacobi alone, the (F, ...) state `b` split by frames over
    `devices`, one process a shard: ``jacobi_smooth_halo`` on every rank.
    Returns the whole solve on the first device, bit for bit
    ``jacobi_smooth(b, lambdas, omega, iterations)``."""
    devices = device_list(devices)
    num_shards = len(devices)
    if b.shape[0] % num_shards:
        raise ValueError(f"{b.shape[0]} frames do not split over {num_shards} shards")
    if num_shards > 1 and b.shape[0] // num_shards < omega:
        raise ValueError(f"halo solve needs shards of >= omega={omega} frames, "
                         f"got {b.shape[0] // num_shards}")
    if num_shards == 1:
        first = devices[0]
        return jacobi_smooth_halo(b.to(first), lambdas.to(first), omega, iterations,
                                  workers.Collectives(0, 1, first))
    return _over_ranks(devices, _smooth_rank, b, lambdas.cpu(), omega, iterations)[0]
