# Frozen copy of meshflow_tpu_torch/metrics/quality.py, plain PyTorch route only.
"""Stabilization quality metrics (the reference's L6): the port of
``meshflow_tpu/metrics/quality.py``.

* cropping ratio and distortion: each unstabilized frame is re-tracked
  into its cropped output (parallel pairs through the plain LK level; no seeding:
  the reference's zero-init tracker population is part of the metric),
  matched with the full RANSAC + least-squares stack, and scored as
  1 / (H00 * H11) and the affine eigenvalue ratio; the caller takes the
  ratio MEAN and the distortion MIN over frames.  Frames whose matching
  fails score 1 and 1.  Frames are matched and scored in batches of
  PAIR_BATCH (``metric_batch``, the JAX package's jitted
  ``cropping_and_distortion_scanned``), padded as the motion batches are.
* stability: per-vertex FFT energy of the differenced displacement
  profiles, fraction in bins [1:6), x and y averaged, then vertices.
"""

from __future__ import annotations

import torch

from .config import MeshFlowConfig
from .eig3 import affine_eigen_ratio
from .fast import Keypoints
from .features import match_from_tracks
from .motion import (
    PAIR_BATCH,
    pack_tile_planes_u8,
    pad_rows,
    padded_count,
    track_planes,
)
from . import prng


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
    rows = padded_count(num_frames)
    keys = prng.fold_in(key, torch.arange(rows, device=device) + key_offset)
    early = pad_rows(unstab_keypoints.positions, rows)
    late_pos, tracked = pad_rows(late_pos, rows), pad_rows(tracked, rows)
    ratios, distortions = [], []
    for s in range(0, rows, PAIR_BATCH):
        sl = slice(s, s + PAIR_BATCH)
        r, d = metric_batch(early[sl], late_pos[sl], tracked[sl], keys[sl], config)
        ratios.append(r)
        distortions.append(d)
    return torch.cat(ratios)[:num_frames], torch.cat(distortions)[:num_frames]


def metric_batch(early, late, tracked, keys, config: MeshFlowConfig):
    """The metric batch, one graph on the card: match a batch of frames
    into their cropped outputs (early, late (T, S, K, 2), tracked (T, S, K),
    keys (T, 2)) and score them: (ratios (T,), distortions (T,))."""
    match = match_from_tracks(early, late, tracked, keys, config)
    h = match.homography
    one = torch.ones_like(h[:, 0, 0])
    ratio = torch.where(match.ok, 1.0 / (h[:, 0, 0] * h[:, 1, 1]), one)
    return ratio, torch.where(match.ok, affine_eigen_ratio(h), one)
