"""Frame-sharded stabilization: the port of
``meshflow_tpu/parallel/pipeline.py``.

The JAX package runs one program over a 1-D device mesh (``shard_map`` in
one process).  The port runs the same steps in one process over a list
of torch devices, one per shard, where a device may repeat; each
collective is an explicit, ordered tensor move:

* ppermute: a neighbour's slice ``.to(device)`` (the one-frame halo that
  lets every shard match its boundary pair, and the halo Jacobi's
  omega-frame halos);
* all_gather: a ``torch.cat`` of the shards' tensors (the shard totals of
  the distributed prefix sum, the homographies for the adaptive weights,
  the solved state for the stability score);
* pmax / pmin / pmean: a reduction over the stacked per-shard values (the
  crop rectangle, the metrics).

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
from meshflow_tpu_torch.parallel import cuda_devices
from meshflow_tpu_torch.render.stabilize import crop_frames, render_stabilized
from meshflow_tpu_torch.solver.jacobi import jacobi_smooth, jacobi_smooth_sharded
from meshflow_tpu_torch.solver.weights import adaptive_weights
from meshflow_tpu_torch.utils import grid, prng

SOLVER_MODES = ("halo", "replicated")


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
    """Stabilize a clip with its frames sharded over `devices`.

    frames: (F, H, W, 3) uint8 BGR on any device, F divisible by the
    number of shards; key: a port key (``utils.prng.PRNGKey``); devices:
    one torch device per shard (default: every CUDA device).  Returns
    (cropped (F, H, W, 3) uint8, crop (4,), cropping_ratio,
    distortion_score, stability_score), all on the first shard's device.

    solver_mode: "halo" keeps the (F, V, 2) solver state sharded and
    exchanges an omega-frame halo per Jacobi sweep, bit-identical to
    "replicated", which gathers the state and solves it whole; shards
    shorter than omega take "replicated".  In serving mode
    (config.compute_metrics off) the cropping ratio and distortion are NaN.
    """
    if solver_mode not in SOLVER_MODES:
        raise ValueError(f"solver_mode {solver_mode!r}: expected one of {SOLVER_MODES}")
    devices = [torch.device(d) for d in (cuda_devices() if devices is None else devices)]
    num_shards = len(devices)
    num_frames = frames.shape[0]
    if num_shards == 0 or num_frames % num_shards:
        raise ValueError(f"{num_frames} frames do not split over {num_shards} shards")
    block = num_frames // num_shards
    omega = config.temporal_smoothing_radius
    if block < omega:
        # the halo reaches one neighbour only
        solver_mode = "replicated"
    h, w = frame_height, frame_width
    first = devices[0]
    frames_local = [frames[i * block : (i + 1) * block].to(d) for i, d in enumerate(devices)]
    keys = [key.to(d) for d in devices]

    # --- halo: each shard receives the next shard's first frame ---------
    keypoints, vel, homo = [], [], []
    for i, d in enumerate(devices):
        halo = frames_local[(i + 1) % num_shards][:1].to(d)
        frames_ext = torch.cat([frames_local[i], halo])
        kps, _ = prepare_frames(frames_ext, config)
        keypoints.append(kps)
        # --- local pair motion (B pairs; the global wrap pair is masked) --
        v, hm, _ = pair_velocities(kps, frames_ext, keys[i], i * block, config, h, w)
        global_pair = i * block + torch.arange(block, device=d)
        valid = global_pair < num_frames - 1
        v = torch.where(valid[:, None, None, None], v, torch.zeros_like(v))
        eye = torch.eye(3, dtype=hm.dtype, device=d).expand_as(hm)
        hm = torch.where(valid[:, None, None], hm, eye)
        vel.append(v)
        homo.append(hm)

    # --- distributed displacement prefix sum ------------------------------
    local_cum = [torch.cumsum(v, dim=0) for v in vel]
    disp_pairs = []
    for i, d in enumerate(devices):
        totals = torch.stack([c[-1].to(d) for c in local_cum])  # all_gather
        before = (torch.arange(num_shards, device=d) < i)[:, None, None, None]
        prefix = torch.where(before, totals, torch.zeros_like(totals)).sum(0)
        disp_pairs.append(local_cum[i] + prefix)  # displacements of frames t+1

    # --- adaptive weights need every pair homography (tiny) ---------------
    homos_full = torch.cat([hm.to(first) for hm in homo])  # all_gather
    lambdas = adaptive_weights(homos_full, w, h, adaptive_weights_definition)

    if solver_mode == "halo":
        # Shift the displacements one frame right across shards: frame iB
        # takes the left neighbour's last prefix (zero on the first shard).
        du_local = []
        for i, d in enumerate(devices):
            prev_tail = (disp_pairs[i - 1][-1:].to(d) if i > 0
                         else torch.zeros_like(disp_pairs[i][-1:]))
            du_local.append(torch.cat([prev_tail, disp_pairs[i][:-1]]))
        ds_local = jacobi_smooth_sharded(du_local, lambdas, omega,
                                         config.optimization_num_iterations)
        stab_full = torch.cat([x.to(first) for x in ds_local])  # all_gather
    else:
        # replicate the tiny temporal state and solve it on each device
        disp_tail = torch.cat([x.to(first) for x in disp_pairs])  # all_gather
        disp_full = torch.cat([torch.zeros_like(disp_tail[:1]), disp_tail[: num_frames - 1]])
        stab_full = jacobi_smooth(disp_full, lambdas, omega, config.optimization_num_iterations)
        du_local = [disp_full[i * block : (i + 1) * block].to(d) for i, d in enumerate(devices)]
        ds_local = [stab_full[i * block : (i + 1) * block].to(d) for i, d in enumerate(devices)]

    # --- render; the crop is the pmax / pmin of the shards' crops ---------
    stabilized, crops = [], []
    for i, d in enumerate(devices):
        unstab_grid = grid.vertex_grid(config, h, w, device=d)
        s, c = render_stabilized(frames_local[i], du_local[i], ds_local[i], unstab_grid,
                                 config, h, w)
        stabilized.append(s)
        crops.append(c.to(first))
    crops = torch.stack(crops)
    crop = torch.stack([crops[:, 0].amax(), crops[:, 1].amax(), crops[:, 2].amin(),
                        crops[:, 3].amin()])
    cropped = [crop_frames(s, crop.to(s.device), h, w) for s in stabilized]
    del stabilized

    # --- metrics: the mean of the shard means, the min of the mins -------
    if config.compute_metrics:
        means, mins = [], []
        for i, d in enumerate(devices):
            ratios, distortions = cropping_and_distortion(
                Keypoints(*(a[:block] for a in keypoints[i])), frames_local[i], cropped[i],
                prng.fold_in(keys[i], 10_000), i * block, config, h, w,
            )
            means.append(ratios.mean().to(first))
            mins.append(distortions.amin().to(first))
        cropping_ratio = torch.stack(means).mean()
        distortion_score = torch.stack(mins).amin()
    else:
        cropping_ratio = distortion_score = torch.tensor(float("nan"), device=first)

    # stability from the gathered solve (the same on every shard)
    stability = stability_score(stab_full)
    cropped = torch.cat([c.to(first) for c in cropped])  # all_gather
    return cropped, crop, cropping_ratio, distortion_score, stability
