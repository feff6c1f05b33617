"""A session of ``OnlineMeshFlowStabilizer.process`` on the plain modules
of this package, batched.

Frame t's motion (frame t-1's keypoints tracked into frame t, matched
with RANSAC keyed by fold_in(key, t - 1), propagated to the vertices)
depends on the two frames alone, so every pair is tracked and matched in
blocks; the causal solve then runs frame by frame on the vertex
velocities, and the warps run in blocks.  The first frame comes back
unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from . import grid, prng
from .features import match_from_tracks
from .jacobi import gaussian_band
from .motion import PAIR_BATCH, pack_tile_planes_u8, prepare_frames, track_planes
from .propagate import vertex_velocities
from .render import BackwardMap, backward_map_plain, crop_resize_frame, warp_frame
from .trackscale import planes_dev
from .weights import adaptive_weights

BLOCK = 64  # frames a motion or render block


def crop_rect(frame_width: int, frame_height: int, crop_ratio: float):
    """The fixed reserved-margin crop [left, top, right, bottom] and the
    margins (x, y)."""
    mx = int(round(frame_width * (1.0 - crop_ratio) / 2))
    my = int(round(frame_height * (1.0 - crop_ratio) / 2))
    return np.asarray([mx, my, frame_width - 1 - mx, frame_height - 1 - my], np.int32), (mx, my)


def pair_motion(frames: torch.Tensor, config, key, h: int, w: int, adaptive_weights_definition):
    """Velocities (N-1, R+1, C+1, 2) and weights lambda (N-1,) of every
    adjacent pair of the session's frames (N, H, W, 3)."""
    device = frames.device
    vgrid = grid.vertex_grid(config, h, w, device=device)
    max_level = config.lk_max_level(h, w)
    velocities, lambdas = [], []
    for start in range(0, frames.shape[0] - 1, BLOCK):
        stop = min(start + BLOCK + 1, frames.shape[0])
        planes_in = planes_dev(frames[start:stop], config)
        kps, _ = prepare_frames(planes_in, config)
        planes, dims = pack_tile_planes_u8(planes_in, config, max_level)
        late, tracked = track_planes(
            kps.positions[:-1], kps.valid[:-1], planes, planes, dims, config, h, w,
            shifted=True,
        )
        pairs = stop - start - 1
        keys = prng.fold_in(key, torch.arange(start, start + pairs, device=device))
        for s in range(0, pairs, PAIR_BATCH):
            sl = slice(s, min(s + PAIR_BATCH, pairs))
            match = match_from_tracks(kps.positions[:-1][sl], late[sl], tracked[sl], keys[sl],
                                      config)
            velocities.append(vertex_velocities(
                match.early, match.late, match.inlier, match.homography, vgrid, config, h, w))
            lambdas.append(adaptive_weights(match.homography, w, h, adaptive_weights_definition))
    return torch.cat(velocities), torch.cat(lambdas)


def causal_shifts(velocities, lambdas, config, limit):
    """p_t - c_t of frames 1..N-1: the causal coordinate-descent step over
    the last OMEGA committed frames, clamped to the margins `limit` (2,)."""
    omega = config.temporal_smoothing_radius
    device = velocities.device
    band = gaussian_band(omega, device)
    unstab = torch.zeros((omega + 1,) + velocities.shape[1:], dtype=torch.float32, device=device)
    stab = unstab.clone()
    ramp = torch.arange(omega, device=device)
    shifts = []
    for step in range(velocities.shape[0]):
        c_t = unstab[-1] + velocities[step]
        unstab = torch.cat([unstab[1:], c_t[None]])
        lam = lambdas[step]
        wgt = torch.where(ramp >= max(omega - step - 1, 0), band[:omega],
                          torch.zeros_like(band[:omega]))
        denom = 1.0 + 2.0 * lam * wgt.sum()
        weighted_past = (wgt[:, None, None, None] * stab[1:]).sum(0)
        p_t = (c_t + 2.0 * lam * weighted_past) / denom
        p_t = c_t + torch.clamp(p_t - c_t, -limit, limit)
        stab = torch.cat([stab[1:], p_t[None]])
        shifts.append(p_t - c_t)
    return torch.stack(shifts)


def stabilize_stream(frames: torch.Tensor, config, seed: int = 0,
                     adaptive_weights_definition: int = 0, crop_ratio: float = 0.8):
    """(N, H, W, 3) uint8 BGR session on a device -> the (N, H, W, 3) uint8
    frames ``process`` returns, frame by frame."""
    device = frames.device
    n, h, w = frames.shape[:3]
    key = prng.PRNGKey(seed, device=device)
    velocities, lambdas = pair_motion(frames, config, key, h, w, adaptive_weights_definition)
    crop, (mx, my) = crop_rect(w, h, crop_ratio)
    limit = torch.tensor([mx, my], dtype=torch.float32, device="cpu")
    shifts = causal_shifts(velocities.cpu(), lambdas.cpu(), config, limit).to(device)
    vgrid = grid.vertex_grid(config, h, w, device=device)
    crop = torch.as_tensor(crop, device=device)
    border = torch.as_tensor(config.color_outside_image_area_bgr, dtype=torch.float32,
                             device=device)
    out = [frames[:1]]
    for start in range(1, n, BLOCK):
        stop = min(start + BLOCK, n)
        bmap = backward_map_plain(vgrid + shifts[start - 1 : stop - 1], vgrid, config, h, w)
        out.append(torch.stack([
            crop_resize_frame(
                warp_frame(frames[start + i], BackwardMap(*(m[i] for m in bmap)), border),
                crop, h, w)
            for i in range(stop - start)
        ]))
    return torch.cat(out)
