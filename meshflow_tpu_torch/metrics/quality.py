"""Stabilization quality metrics (the reference's L6): the port of
``meshflow_tpu/metrics/quality.py``.

* cropping ratio and distortion: each unstabilized frame is re-tracked
  into its cropped output (parallel pairs through kernel A, no seeding:
  the reference's zero-init tracker population is part of the metric),
  matched with the full RANSAC + least-squares stack, and scored as
  1 / (H00 * H11) and the affine eigenvalue ratio; the caller takes the
  ratio MEAN and the distortion MIN over frames.  Frames whose matching
  fails score 1 and 1.
* stability: per-vertex FFT energy of the differenced displacement
  profiles, fraction in bins [1:6), x and y averaged, then vertices.
"""

from __future__ import annotations

import torch

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels.eig3 import affine_eigen_ratio
from meshflow_tpu_torch.kernels.fast import Keypoints
from meshflow_tpu_torch.motion.features import match_from_tracks
from meshflow_tpu_torch.motion.pipeline import (
    PAIR_BATCH,
    pack_tile_planes_u8,
    track_planes,
)
from meshflow_tpu_torch.utils import prng


def stability_score(stab_disp: torch.Tensor) -> torch.Tensor:
    """stab_disp: (F, R+1, C+1, 2) -> scalar stability score."""
    profiles = torch.diff(stab_disp, dim=0)
    energy = torch.abs(torch.fft.fft(profiles, dim=0)) ** 2
    total = energy.sum(0)
    low = energy[1:6].sum(0)
    positive = total > 0
    score = torch.where(
        positive, low / torch.where(positive, total, torch.ones_like(total)),
        torch.zeros_like(total),
    )
    return (score[..., 0].mean() + score[..., 1].mean()) / 2.0


def cropping_and_distortion(
    unstab_keypoints: Keypoints,
    unstab_frames: torch.Tensor,
    cropped_frames: torch.Tensor,
    key: torch.Tensor,
    key_offset: int,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
):
    """Per-frame (ratios (F,), distortions (F,)) of a block of frames;
    frame t draws its RANSAC samples from fold_in(key, t + key_offset)."""
    device = unstab_frames.device
    max_level = config.lk_max_level(frame_height, frame_width)
    planes_un, dims = pack_tile_planes_u8(unstab_frames, config, max_level)
    planes_cr, _ = pack_tile_planes_u8(cropped_frames, config, max_level)
    late_pos, tracked = track_planes(
        unstab_keypoints.positions, unstab_keypoints.valid, planes_un, planes_cr,
        dims, config, frame_height, frame_width, shifted=False,
    )
    num_frames = unstab_frames.shape[0]
    keys = prng.fold_in(key, torch.arange(num_frames, device=device) + key_offset)
    ratios, distortions = [], []
    for s in range(0, num_frames, PAIR_BATCH):
        sl = slice(s, min(s + PAIR_BATCH, num_frames))
        match = match_from_tracks(
            unstab_keypoints.positions[sl], late_pos[sl], tracked[sl], keys[sl], config
        )
        h = match.homography
        one = torch.ones_like(h[:, 0, 0])
        ratios.append(torch.where(match.ok, 1.0 / (h[:, 0, 0] * h[:, 1, 1]), one))
        distortions.append(torch.where(match.ok, affine_eigen_ratio(h), one))
    return torch.cat(ratios), torch.cat(distortions)
