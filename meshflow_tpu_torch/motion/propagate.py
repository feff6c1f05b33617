"""Feature -> mesh-vertex motion propagation (the reference's L3), batched
over frame pairs: the port of ``meshflow_tpu/motion/propagate.py``.

Global vertex motion through the pair homography, plus the per-vertex
median of the inlier features' residual velocities inside each feature's
mesh-cell ellipse (0 where no feature reaches), then a 3x3 spatial
median.
"""

from __future__ import annotations

import torch

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels.homography import apply_homography
from meshflow_tpu_torch.kernels.median import masked_median, median3x3


def ellipse_membership(
    feature_pos: torch.Tensor,
    valid: torch.Tensor,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
) -> torch.Tensor:
    """(..., R+1, C+1, N) bool: feature n contributes to vertex (r, c) iff
    the vertex lies inside its ellipse.  feature_pos (..., N, 2)."""
    re = float(config.feature_ellipse_row_count)
    ce = float(config.feature_ellipse_col_count)
    device = feature_pos.device
    fr = (feature_pos[..., 1] / frame_height) * config.mesh_row_count  # (..., N)
    fc = (feature_pos[..., 0] / frame_width) * config.mesh_col_count
    r = torch.arange(config.vertex_rows, dtype=torch.float32, device=device)
    c = torch.arange(config.vertex_cols, dtype=torch.float32, device=device)
    diff_r = r[:, None] - fr[..., None, :]  # (..., R+1, N)
    dr = diff_r / re
    row_ok = torch.abs(diff_r) <= re / 2.0
    half_width = ce * torch.sqrt(torch.clamp(0.25 - dr * dr, min=0.0))
    dc = c[:, None] - fc[..., None, None, :]  # (..., 1, C+1, N)
    col_ok = torch.abs(dc) <= half_width[..., :, None, :]
    return col_ok & row_ok[..., :, None, :] & valid[..., None, None, :]


def vertex_velocities(
    early: torch.Tensor,
    late: torch.Tensor,
    inlier: torch.Tensor,
    homography: torch.Tensor,
    vertex_grid: torch.Tensor,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
) -> torch.Tensor:
    """(..., R+1, C+1, 2) vertex velocities of a batch of pairs.

    early, late: (..., N, 2); inlier: (..., N); homography (..., 3, 3);
    vertex_grid (R+1, C+1, 2)."""
    vr, vc = config.vertex_rows, config.vertex_cols
    batch = homography.shape[:-2]
    grid_flat = vertex_grid.reshape(-1, 2)
    global_vel = (apply_homography(homography, grid_flat) - grid_flat).reshape(
        batch + (vr, vc, 2)
    )
    residual = late - apply_homography(homography, early)  # (..., N, 2)
    member = ellipse_membership(early, inlier, config, frame_height, frame_width)
    res = [
        masked_median(residual[..., None, None, :, i].expand(member.shape), member)
        for i in (0, 1)
    ]
    vel_x = global_vel[..., 0] + res[0]
    vel_y = global_vel[..., 1] + res[1]
    return torch.stack([median3x3(vel_x), median3x3(vel_y)], dim=-1)
