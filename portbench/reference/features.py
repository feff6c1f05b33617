# Frozen copy of meshflow_tpu_torch/motion/features.py, plain PyTorch route only.
"""Per-pair matching from LK tracks: per-subframe RANSAC, then one global
least-squares homography (the port of ``match_from_tracks`` in
``meshflow_tpu/motion/features.py``), batched over frame pairs.

Ragged OpenCV arrays are fixed-capacity (S, K) tensors with masks.  When
fewer than ``homography_min_number_corresponding_features`` survive, the
pair is defined as ok=False with the identity homography.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import MeshFlowConfig
from .homography import (
    estimate_homography,
    ransac_homography,
)
from . import prng


class MatchResult(NamedTuple):
    """Fixed-capacity match sets of a batch of pairs (N = S*K slots)."""

    early: torch.Tensor  # (..., N, 2) float32 positions in the early frame
    late: torch.Tensor  # (..., N, 2) tracked positions in the late frame
    inlier: torch.Tensor  # (..., N) bool: tracked and subframe-RANSAC inlier
    homography: torch.Tensor  # (..., 3, 3) early->late (identity if not ok)
    ok: torch.Tensor  # (...) bool: >= min corresponding features survived


def match_from_tracks(
    early_pos: torch.Tensor,
    late_pos: torch.Tensor,
    tracked: torch.Tensor,
    keys: torch.Tensor,
    config: MeshFlowConfig,
) -> MatchResult:
    """early_pos, late_pos: (T, S, K, 2); tracked: (T, S, K) bool; keys:
    (T, 2) one RANSAC key per pair (split into one key per subframe)."""
    t, s, k = tracked.shape
    sub_keys = prng.split(keys, s)  # (T, S, 2)
    _, mask, ok_s = ransac_homography(
        early_pos,
        late_pos,
        tracked,
        sub_keys,
        threshold=config.ransac_reproj_threshold,
        iterations=config.ransac_iterations,
        refine_iterations=config.homography_refine_iterations,
        polish_rounds=config.ransac_polish_rounds,
    )
    inlier = (mask & ok_s[..., None]).reshape(t, s * k)
    flat_early = early_pos.reshape(t, s * k, 2)
    flat_late = late_pos.reshape(t, s * k, 2)
    count = inlier.sum(-1)
    ok = count >= config.homography_min_number_corresponding_features
    h = estimate_homography(
        flat_early, flat_late, inlier.to(torch.float32),
        config.homography_refine_iterations,
    )
    finite = torch.isfinite(h).flatten(-2).all(-1)
    identity = torch.eye(3, dtype=torch.float32, device=h.device)
    h = torch.where((ok & finite)[:, None, None], h, identity)
    return MatchResult(
        early=flat_early,
        late=flat_late,
        inlier=inlier & ok[:, None],
        homography=h,
        ok=ok,
    )
