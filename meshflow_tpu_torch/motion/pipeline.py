"""Whole-clip motion estimation (the reference's stage 2): the port of
``meshflow_tpu/motion/pipeline.py`` on its kernel-tracker route.

Per block of frames: pack the uint8 tile pyramids once, track every
adjacent pair's keypoints with the LK kernel that MESHFLOW_LK_FETCH names
(kernel A or C, one launch per pyramid level for all pairs), then match and
propagate the pairs in batches of ``PAIR_BATCH``, and integrate the
per-pair vertex velocities with a cumulative sum.  The JAX package's jitted
scan of ``match_from_tracks`` + ``vertex_velocities`` becomes a loop over
batches, on the card each one replay of a CUDA graph of the caller's
runner (``utils/graphs.GraphRunner``).  Every batch is padded to ``PAIR_BATCH``
pairs, so a clip geometry has one batch shape: the padding pairs track
nothing, draw from the keys past the block's last pair, and are dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels.color import bgr_to_gray
from meshflow_tpu_torch.kernels.fast import Keypoints, detect_keypoints
from meshflow_tpu_torch.kernels.lk import reflect_pad_level
from meshflow_tpu_torch.kernels.lk_cuda import lk_track_parallel
from meshflow_tpu_torch.kernels.pyramid import pyr_down
from meshflow_tpu_torch.motion.features import match_from_tracks
from meshflow_tpu_torch.motion.propagate import vertex_velocities
from meshflow_tpu_torch.utils import grid, graphs, prng

# Pixels a FAST call: its working set (~380 bytes a pixel, 1.4 GB at 16
# frames of 640x360) is the largest transient of a pass-1 window, and the
# device memory it leaves cached is what the window's tracking shares.
_DETECT_PIXEL_BUDGET = 16 * 640 * 360
# Pairs matched and propagated together: bounds the (pairs, V, S*K)
# ellipse-median tensors to ~2 GB at the default geometry.
PAIR_BATCH = 16


def padded_count(count: int) -> int:
    """`count` rounded up to whole batches of PAIR_BATCH."""
    return -(-count // PAIR_BATCH) * PAIR_BATCH


def pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """`t` with zero rows (False for bool: untracked) appended up to `rows`."""
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


class MotionEstimate(NamedTuple):
    """Stage-2 outputs for a clip of F frames."""

    displacements: torch.Tensor  # (F, R+1, C+1, 2) float32, frame 0 == 0
    homographies: torch.Tensor  # (F, 3, 3) float32, index F-1 == identity
    pair_ok: torch.Tensor  # (F-1,) bool


def detect_all_frames(
    gray8: torch.Tensor, config: MeshFlowConfig, frame_height: int, frame_width: int
) -> Keypoints:
    """FAST keypoints of every frame, in blocks bounded by a pixel budget."""
    chunk = max(1, min(32, _DETECT_PIXEL_BUDGET // (frame_height * frame_width)))
    parts = [
        detect_keypoints(gray8[i : i + chunk], config, frame_height, frame_width)
        for i in range(0, gray8.shape[0], chunk)
    ]
    return Keypoints(*(torch.cat(p) for p in zip(*parts)))


def prepare_frames(frames_bgr: torch.Tensor, config: MeshFlowConfig):
    """(F, H, W, 3) uint8 BGR or (F, H, W, 1) uint8 gray planes (the
    track_planes="gray" route) -> (keypoints, gray8 (F, H, W)); detection
    sees the same gray either way."""
    _, h, w = frames_bgr.shape[:3]
    gray8 = frames_bgr[..., 0] if frames_bgr.shape[-1] == 1 else bgr_to_gray(frames_bgr)
    return detect_all_frames(gray8, config, h, w), gray8


def split_tiles(img: torch.Tensor, config: MeshFlowConfig) -> torch.Tensor:
    """(..., H, W) -> (..., S, tile_h, tile_w), s = col * rows + row.

    Frames that do not divide evenly are edge-padded."""
    h, w = img.shape[-2], img.shape[-1]
    rows = config.mesh_outlier_subframe_row_count
    cols = config.mesh_outlier_subframe_col_count
    tile_h, tile_w = config.subframe_shape(h, w)
    pad_h, pad_w = rows * tile_h - h, cols * tile_w - w
    if pad_h or pad_w:
        iy = torch.clamp(torch.arange(rows * tile_h, device=img.device), max=h - 1)
        ix = torch.clamp(torch.arange(cols * tile_w, device=img.device), max=w - 1)
        img = img.index_select(-2, iy).index_select(-1, ix)
    batch = img.shape[:-2]
    g = img.reshape(batch + (rows, tile_h, cols, tile_w))
    g = g.movedim(-2, -4)  # (..., cols, rows, tile_h, tile_w)
    return g.reshape(batch + (rows * cols, tile_h, tile_w))


def pack_tile_planes_u8(frames: torch.Tensor, config: MeshFlowConfig, max_level: int):
    """Tile pyramids for LK: (F, H, W, C) uint8 -> (planes, dims), planes a
    tuple over levels of (F, S, C, rows_l + 2*PAD, cols_l + 2*PAD) uint8
    REFLECT_101-padded, dims the (rows_l, cols_l) of each level."""
    chans = frames.movedim(-1, 1)  # (F, C, H, W)
    tiles8 = split_tiles(chans, config).transpose(1, 2).contiguous()  # (F,S,C,th,tw)
    planes = [reflect_pad_level(tiles8)]
    dims = [(tiles8.shape[-2], tiles8.shape[-1])]
    cur = tiles8.to(torch.float32)
    for _ in range(max_level):
        cur = pyr_down(cur)
        planes.append(reflect_pad_level(cur).to(torch.uint8))
        dims.append((cur.shape[-2], cur.shape[-1]))
    return tuple(planes), tuple(dims)


def subframe_offsets_f32(
    config: MeshFlowConfig, frame_height: int, frame_width: int, device
) -> torch.Tensor:
    """The subframes' top-left corners as float32 (1, S, 1, 2), the shape
    ``track_planes`` subtracts from frame-relative positions."""
    return grid.subframe_offsets(config, frame_height, frame_width, device=device).to(
        torch.float32
    )[None, :, None, :]


def track_planes(
    positions: torch.Tensor,
    valid: torch.Tensor,
    prev_planes,
    next_planes,
    dims,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
    shifted: bool,
    offsets: torch.Tensor | None = None,
):
    """LK-track frame-relative keypoints (T, S, K, 2) through tile planes;
    returns (late positions, frame-relative; tracked (T, S, K)).  offsets:
    ``subframe_offsets_f32`` made beforehand (a captured step copies
    nothing from the host), else made here."""
    if offsets is None:
        offsets = subframe_offsets_f32(config, frame_height, frame_width, positions.device)
    late_local, tracked = lk_track_parallel(
        prev_planes,
        next_planes,
        dims,
        positions - offsets,
        valid,
        shifted=shifted,
        max_iters=config.lk_max_iterations,
        eps=config.lk_epsilon,
        min_eig_threshold=config.lk_min_eig_threshold,
    )
    return late_local + offsets, tracked


def track_pairs(
    keypoints: Keypoints,
    frames_bgr: torch.Tensor,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
):
    """LK-track every frame's keypoints into the next frame (all pairs):
    (late_pos (F-1, S, K, 2) frame-relative, tracked (F-1, S, K))."""
    max_level = config.lk_max_level(frame_height, frame_width)
    planes, dims = pack_tile_planes_u8(frames_bgr, config, max_level)
    return track_planes(
        keypoints.positions[:-1], keypoints.valid[:-1], planes, planes, dims,
        config, frame_height, frame_width, shifted=True,
    )


def motion_batch(
    early: torch.Tensor,
    late: torch.Tensor,
    tracked: torch.Tensor,
    keys: torch.Tensor,
    vgrid: torch.Tensor,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
):
    """The motion batch, one graph on the card: match and propagate a batch
    of pairs (early, late (T, S, K, 2), tracked (T, S, K), keys (T, 2),
    vgrid the vertex grid).  Returns (velocities (T, R+1, C+1, 2),
    homographies (T, 3, 3), ok (T,))."""
    match = match_from_tracks(early, late, tracked, keys, config)
    velocities = vertex_velocities(
        match.early, match.late, match.inlier, match.homography, vgrid,
        config, frame_height, frame_width,
    )
    return velocities, match.homography, match.ok


def pair_velocities(
    keypoints: Keypoints,
    frames_bgr: torch.Tensor,
    key: torch.Tensor,
    key_offset: int,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
    runner: graphs.GraphRunner | None = None,
):
    """Track, match and propagate the F-1 adjacent pairs of a frame block.

    Pair t draws its RANSAC samples from fold_in(key, t + key_offset).
    The pairs are matched in batches of PAIR_BATCH, the last one padded,
    each through `runner` (a CUDA graph a batch shape on the card; None
    runs them directly).  Returns (velocities (F-1, R+1, C+1, 2),
    homographies (F-1, 3, 3), ok (F-1,))."""
    device = frames_bgr.device
    vgrid = grid.vertex_grid(config, frame_height, frame_width, device=device)
    late_pos, tracked = track_pairs(
        keypoints, frames_bgr, config, frame_height, frame_width
    )
    num_pairs = frames_bgr.shape[0] - 1
    rows = padded_count(num_pairs)
    keys = prng.fold_in(key, torch.arange(rows, device=device) + key_offset)
    early = pad_rows(keypoints.positions[:num_pairs], rows)
    late_pos, tracked = pad_rows(late_pos, rows), pad_rows(tracked, rows)
    vel, homo, ok = [], [], []
    for s in range(0, rows, PAIR_BATCH):
        sl = slice(s, s + PAIR_BATCH)
        v, h, o = graphs.run(
            runner, motion_batch, (early[sl], late_pos[sl], tracked[sl], keys[sl], vgrid),
            config, frame_height, frame_width,
        )
        vel.append(v)
        homo.append(h)
        ok.append(o)
    return tuple(torch.cat(parts)[:num_pairs] for parts in (vel, homo, ok))


def integrate_velocities(velocities, homographies, pair_ok) -> MotionEstimate:
    """(F-1) per-pair outputs -> MotionEstimate (cumsum + identity tail)."""
    zero = torch.zeros_like(velocities[:1])
    displacements = torch.cat([zero, torch.cumsum(velocities, dim=0)])
    eye = torch.eye(3, dtype=torch.float32, device=homographies.device)[None]
    return MotionEstimate(
        displacements=displacements,
        homographies=torch.cat([homographies, eye]),
        pair_ok=pair_ok,
    )
