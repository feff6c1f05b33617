"""FAST-9/16 corners per subframe with a fixed top-K capacity.

Port of ``meshflow_tpu/kernels/fast.py``: OpenCV's segment test and
corner score for every pixel by shift-and-compare over the 16-pixel
Bresenham circle, zeroed within 3 px of every subframe edge (the
reference detects on subframe views), 3x3 non-max suppression with
OpenCV's strict-greater rule, then the K best per subframe.

The JAX package takes the K best with ``jax.lax.top_k``, which orders
equal scores by ascending index; ``torch.topk`` promises no order for
ties, so the port takes a stable descending sort, which gives the same
(score desc, index asc) order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from meshflow_tpu_torch.config import MeshFlowConfig

# OpenCV's 16-pixel circle, (dx, dy), clockwise from the top.
CIRCLE_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoints per subframe.

    positions: (..., S, K, 2) float32 frame-relative [x, y]
    scores:    (..., S, K) int32
    valid:     (..., S, K) bool
    """

    positions: torch.Tensor
    scores: torch.Tensor
    valid: torch.Tensor


def _shift2d(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], zero outside (borders are masked)."""
    h, w = img.shape[-2], img.shape[-1]
    p = F.pad(img, (3, 3, 3, 3))
    return p[..., 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w]


def fast_score_map(gray: torch.Tensor) -> torch.Tensor:
    """OpenCV cornerScore<16> per pixel: int32 (..., H, W) from uint8.

    Max over the 16 cyclic 9-pixel arcs of the arc's minimum brightness
    difference (both polarities), minus 1; score >= t is the segment test.
    """
    g = gray.to(torch.int32)
    diffs = [_shift2d(g, dx, dy) - g for dx, dy in CIRCLE_OFFSETS]

    def arc_min9(d):
        m2 = [torch.minimum(d[k], d[(k + 1) % 16]) for k in range(16)]
        m4 = [torch.minimum(m2[k], m2[(k + 2) % 16]) for k in range(16)]
        m8 = [torch.minimum(m4[k], m4[(k + 4) % 16]) for k in range(16)]
        out = torch.minimum(m8[0], d[8])
        for k in range(1, 16):
            out = torch.maximum(out, torch.minimum(m8[k], d[(k + 8) % 16]))
        return out

    bright = arc_min9(diffs)
    dark = arc_min9([-d for d in diffs])
    return torch.maximum(bright, dark) - 1


def _dead_zone_mask(
    frame_height: int, frame_width: int, sub_h: int, sub_w: int
) -> np.ndarray:
    """bool (H, W), True where a pixel is >= 3 px inside its subframe."""
    y = np.arange(frame_height)
    x = np.arange(frame_width)
    y_in = y % sub_h
    x_in = x % sub_w
    sub_height = np.minimum(sub_h, frame_height - (y - y_in))
    sub_width = np.minimum(sub_w, frame_width - (x - x_in))
    y_ok = (y_in >= 3) & (y_in <= sub_height - 4)
    x_ok = (x_in >= 3) & (x_in <= sub_width - 4)
    return y_ok[:, None] & x_ok[None, :]


def detect_keypoints(
    gray: torch.Tensor,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
) -> Keypoints:
    """uint8 (..., H, W) -> Keypoints with S subframes of K slots each,
    ordered by descending score, ties by ascending scan index."""
    sub_h, sub_w = config.subframe_shape(frame_height, frame_width)
    rows = config.mesh_outlier_subframe_row_count
    cols = config.mesh_outlier_subframe_col_count
    k = config.max_features_per_subframe
    device = gray.device

    score = fast_score_map(gray)
    inside = torch.from_numpy(
        _dead_zone_mask(frame_height, frame_width, sub_h, sub_w)
    ).to(device)
    score = torch.where(inside, score, torch.zeros_like(score))

    corner = score >= config.fast_threshold
    corner_score = torch.where(corner, score, torch.zeros_like(score))
    neighbor_max = torch.zeros_like(corner_score)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx or dy:
                neighbor_max = torch.maximum(
                    neighbor_max, _shift2d(corner_score, dx, dy)
                )
    keep = corner & (corner_score > neighbor_max)
    final_score = torch.where(keep, score, torch.zeros_like(score))

    pad_h = rows * sub_h - frame_height
    pad_w = cols * sub_w - frame_width
    batch = final_score.shape[:-2]
    padded = F.pad(final_score, (0, pad_w, 0, pad_h))
    tiled = padded.reshape(batch + (rows, sub_h, cols, sub_w))
    # subframe s = col * rows + row (the reference's visit order)
    tiled = tiled.movedim(-2, -3).transpose(-4, -3)
    flat = tiled.reshape(batch + (rows * cols, sub_h * sub_w))

    k_eff = min(k, sub_h * sub_w)
    top_scores, top_idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top_scores = top_scores[..., :k_eff]
    top_idx = top_idx[..., :k_eff]
    if k_eff < k:
        top_scores = F.pad(top_scores, (0, k - k_eff))
        top_idx = F.pad(top_idx, (0, k - k_eff))
    valid = top_scores >= config.fast_threshold

    y_in = (top_idx // sub_w).to(torch.float32)
    x_in = (top_idx % sub_w).to(torch.float32)
    s_ids = torch.arange(rows * cols, device=device)
    shape_s = (1,) * len(batch) + (rows * cols, 1)
    x = x_in + ((s_ids // rows) * sub_w).reshape(shape_s).to(torch.float32)
    y = y_in + ((s_ids % rows) * sub_h).reshape(shape_s).to(torch.float32)
    positions = torch.stack([x, y], dim=-1)
    return Keypoints(
        positions=positions, scores=top_scores.to(torch.int32), valid=valid
    )
