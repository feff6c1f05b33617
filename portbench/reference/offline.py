"""The in-memory clip route: ``MeshFlowStabilizer._stabilize_frames`` on
the plain modules of this package."""

from __future__ import annotations

import torch

from . import grid, prng, trackscale
from .fast import Keypoints
from .motion import estimate_motion_chunked, prepare_frames
from .quality import cropping_and_distortion, stability_score
from .render import crop_frames, intersect_crops, render_block
from .jacobi import jacobi_smooth
from .weights import adaptive_weights

CHUNK = 64  # frames per render / metric block; motion blocks hold CHUNK - 1 pairs


def stabilize_clip(frames: torch.Tensor, config, seed: int = 0,
                   adaptive_weights_definition: int = 0):
    """(F, H, W, 3) uint8 BGR on a device -> (cropped (F, H, W, 3) uint8,
    crop (4,), cropping ratio, distortion, stability), the scores NaN where
    ``config.compute_metrics`` is off."""
    device = frames.device
    key = prng.PRNGKey(seed, device=device)
    num_frames, h, w = frames.shape[:3]
    chunk = min(CHUNK, num_frames)
    unstab_grid = grid.vertex_grid(config, h, w, device=device)
    d_track = config.resolve_track_downscale(h, w)
    th, tw = config.track_shape(h, w)
    frames_track = trackscale.to_track_planes_dev(frames, config)
    sx, sy = trackscale.scale_factors(h, w, config)
    rerender = trackscale.metric_rerender(config, h, w)

    keypoints, _ = prepare_frames(frames_track, config)
    motion = estimate_motion_chunked(
        keypoints, frames_track, prng.fold_in(key, 1), config, th, tw,
        chunk_pairs=max(chunk - 1, 1),
    )
    if d_track > 1:
        motion = motion._replace(
            displacements=trackscale.scale_velocities(motion.displacements, sx, sy),
            homographies=trackscale.conjugate_homographies(motion.homographies, sx, sy),
        )
    lambdas = adaptive_weights(motion.homographies, w, h, adaptive_weights_definition)
    stab_disp = jacobi_smooth(
        motion.displacements, lambdas, config.temporal_smoothing_radius,
        config.optimization_num_iterations,
    )

    stabilized, stabilized_track, crops = [], [], []
    for start in range(0, num_frames, chunk):
        sl = slice(start, start + chunk)
        s, s_track, c = render_block(
            frames[sl], frames_track[sl] if rerender else None,
            motion.displacements[sl], stab_disp[sl], unstab_grid, config, h, w)
        stabilized.append(s)
        stabilized_track.append(s_track)
        crops.append(c)
    crop = intersect_crops(crops)
    cropped = torch.cat([crop_frames(s, crop, h, w) for s in stabilized])
    del stabilized
    stability = stability_score(stab_disp)
    if not config.compute_metrics:
        nan = torch.tensor(float("nan"), device=device)
        return cropped, crop, nan, nan, stability

    ratios, distortions = [], []
    metric_key = prng.fold_in(key, 2)
    for start in range(0, num_frames, chunk):
        sl = slice(start, start + chunk)
        if rerender:
            cropped_c = crop_frames(stabilized_track[start // chunk], crop, h, w)
        else:
            cropped_c = trackscale.to_track_planes_dev(cropped[sl], config)
        r, d = cropping_and_distortion(
            Keypoints(*(a[sl] for a in keypoints)), frames_track[sl], cropped_c,
            metric_key, start, config, th, tw,
        )
        ratios.append(r)
        distortions.append(d)
    return (cropped, crop, torch.cat(ratios).mean(), torch.cat(distortions).amin(),
            stability)
