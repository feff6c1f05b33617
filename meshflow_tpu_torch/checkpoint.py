"""Checkpoint / resume of the streaming pipeline's pass 1: the port of
``meshflow_tpu/checkpoint.py``.

Pass 1 (decode, detection, LK, RANSAC and propagation over every frame
pair) is the expensive state; its outputs are small per-frame arrays:
displacements (F, R+1, C+1, 2), homographies (F, 3, 3), the pair flags and
the keypoints the metric pass reuses.  Persisting them lets a killed run
restart at the solver, and lets the same clip be stabilized under another
variant (only the solver reads the variant) without running pass 1 again.

The cache key covers the clip (path, size, mtime), the motion config
fields and the tracker.  The tracker names the port and the route: the
hand kernel on the card (kernel A, or C, which is bit-identical to A: one
key) or the plain version on the CPU.  Kernel A is not bit-identical to
its plain version, so the two routes never share a checkpoint, and no key
of the port equals a key of the JAX package (``pallas-r2`` / ``xla-r2``),
so checkpoints never cross between the packages.  A key mismatch, a
corrupt file or one of another clip length recomputes: a checkpoint is an
optimization, never a correctness input.  The ``npz`` layout and
``FORMAT_VERSION`` are the JAX package's.
"""

from __future__ import annotations

import hashlib
import os
import zipfile
from typing import NamedTuple, Optional

import numpy as np
import torch

FORMAT_VERSION = 1

# Bump when a tracker's numerics change: the checkpoint caches tracker
# outputs, so a stale revision must miss, not silently hit.
LK_KERNEL_REVISION = 2  # 2: the card's DLT null vector from the eig9 kernel


class MotionCheckpoint(NamedTuple):
    displacements: np.ndarray  # (F, R+1, C+1, 2) float32
    homographies: np.ndarray  # (F, 3, 3) float32
    pair_ok: np.ndarray  # (F-1,) bool
    kp_positions: np.ndarray  # (F, S, K, 2) float32
    kp_scores: np.ndarray  # (F, S, K) float32
    kp_valid: np.ndarray  # (F, S, K) bool


def _motion_config_key(config, device) -> str:
    """The config fields pass 1 depends on (solver and render fields
    excluded), with the tracker of `device`: the CUDA kernels or the
    plain version."""
    tracker = "cuda" if torch.device(device).type == "cuda" else "plain"
    fields = (
        f"torch-{tracker}-r{LK_KERNEL_REVISION}",
        config.mesh_row_count,
        config.mesh_col_count,
        config.mesh_outlier_subframe_row_count,
        config.mesh_outlier_subframe_col_count,
        config.feature_ellipse_row_count,
        config.feature_ellipse_col_count,
        config.homography_min_number_corresponding_features,
        config.max_features_per_subframe,
        config.fast_threshold,
        config.lk_max_iterations,
        config.lk_epsilon,
        config.lk_min_eig_threshold,
        config.ransac_iterations,
        config.ransac_polish_rounds,
        config.homography_refine_iterations,
        config.track_planes,
        config.track_downscale,
    )
    return repr(fields)


def cache_path(checkpoint_dir: str, input_path: str, config, seed_key: int, device) -> str:
    st = os.stat(input_path)
    key = "|".join(
        [
            str(FORMAT_VERSION),
            os.path.abspath(input_path),
            str(st.st_size),
            str(int(st.st_mtime)),
            _motion_config_key(config, device),
            str(seed_key),
        ]
    )
    digest = hashlib.sha256(key.encode()).hexdigest()[:24]
    return os.path.join(checkpoint_dir, f"motion-{digest}.npz")


def save_motion(path: str, ckpt: MotionCheckpoint) -> None:
    """Write atomically: a temporary file, then a rename."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **ckpt._asdict())
    os.replace(tmp, path)


def load_motion(path: str) -> Optional[MotionCheckpoint]:
    """The checkpoint at `path`, or None when it is missing or unreadable."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as data:
            return MotionCheckpoint(**{name: data[name] for name in MotionCheckpoint._fields})
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None  # corrupt or partial checkpoint: recompute
