"""Mesh warp, crop detection and crop+stretch: the port of
``meshflow_tpu/render/stabilize.py``.

1. Per mesh cell, the stabilized->unstabilized homography from its four
   corner pairs in closed form (``cell_inverse_homographies``).
2. Per output pixel, the backward map: a 3-step fixed-point search
   "cell containing q, then q <- H_cell^-1 p" (grid lines are
   ceil((L-1) i / n)), then the reference's compositing over the 3x3
   candidate cells around the converged one: the pixel belongs to a cell
   when H_cell^-1 p lies strictly inside the cell's integer bbox grown by
   1 px, and the highest row-major cell wins.  Uncovered pixels map to the
   sentinel (W+1, H+1).  ``backward_map_plain`` is the plain version;
   ``kernels/bmap_cuda.backward_map`` routes a CUDA tensor to kernel B.
3. The bilinear warp with the border colour, the per-frame crop edges,
   and the crop+stretch back to full size (cv2.resize semantics).

Homography tables are read directly in float32; the JAX package's bf16
Dekker split and uint32 BGR packing were TPU workarounds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels.homography import quad_to_quad_homography


class BackwardMap(NamedTuple):
    map_x: torch.Tensor  # (..., H, W) float32 source x (W+1 if uncovered)
    map_y: torch.Tensor  # (..., H, W) float32 source y (H+1 if uncovered)
    covered: torch.Tensor  # (..., H, W) bool


def cell_inverse_homographies(
    stab_pos: torch.Tensor, unstab_grid: torch.Tensor, config: MeshFlowConfig
) -> torch.Tensor:
    """(..., cells, 3, 3) stabilized->unstabilized homography per cell.

    stab_pos: (..., R+1, C+1, 2); unstab_grid: (R+1, C+1, 2).  Corners in
    the order the reference passes them to cv2.findHomography.
    """
    cells = config.mesh_row_count * config.mesh_col_count

    def corners(pos):
        stacked = torch.stack(
            [pos[..., :-1, :-1, :], pos[..., :-1, 1:, :],
             pos[..., 1:, :-1, :], pos[..., 1:, 1:, :]],
            dim=-2,
        )  # (..., R, C, 4, 2)
        return stacked.reshape(pos.shape[:-3] + (cells, 4, 2))

    stab_c = corners(stab_pos)
    unstab_c = corners(unstab_grid).expand_as(stab_c)
    return quad_to_quad_homography(stab_c, unstab_c)


def grid_line(i, length: int, count: int):
    """ceil((length-1) * i / count) in integer arithmetic."""
    return -(-((length - 1) * i) // count)


def cell_table(
    h_table: torch.Tensor, config: MeshFlowConfig, frame_height: int, frame_width: int
) -> torch.Tensor:
    """(..., cells, 13) float32: 9 homography coefficients, then the cell's
    integer bbox [left, right, top, bottom]."""
    rc, cc = config.mesh_row_count, config.mesh_col_count
    device = h_table.device
    cols = torch.arange(cc, device=device)
    rows = torch.arange(rc, device=device)
    bbox = torch.stack(
        [
            grid_line(cols, frame_width, cc).repeat(rc),
            grid_line(cols + 1, frame_width, cc).repeat(rc),
            grid_line(rows, frame_height, rc).repeat_interleave(cc),
            grid_line(rows + 1, frame_height, rc).repeat_interleave(cc),
        ],
        dim=-1,
    ).to(torch.float32)
    flat = h_table.reshape(h_table.shape[:-2] + (9,))
    return torch.cat([flat, bbox.expand(flat.shape[:-1] + (4,))], dim=-1)


def _apply_cells(table, cell_ids, px, py):
    """Apply each pixel's cell homography: table (cells, 13)."""
    h = table[cell_ids]  # (P, 13)
    d = h[:, 6] * px + h[:, 7] * py + h[:, 8]
    d = torch.where(torch.abs(d) < 1e-10, torch.full_like(d, 1e-10), d)
    qx = (h[:, 0] * px + h[:, 1] * py + h[:, 2]) / d
    qy = (h[:, 3] * px + h[:, 4] * py + h[:, 5]) / d
    return qx, qy, h


def backward_map_frame_plain(
    table: torch.Tensor, config: MeshFlowConfig, frame_height: int, frame_width: int
) -> BackwardMap:
    """Backward map of one frame from its (cells, 13) cell table."""
    rc, cc = config.mesh_row_count, config.mesh_col_count
    device = table.device
    ys = torch.arange(frame_height, dtype=torch.float32, device=device)
    xs = torch.arange(frame_width, dtype=torch.float32, device=device)
    py = ys[:, None].expand(frame_height, frame_width).reshape(-1)
    px = xs[None, :].expand(frame_height, frame_width).reshape(-1)
    lines_x = grid_line(torch.arange(1, cc, device=device), frame_width, cc).float()
    lines_y = grid_line(torch.arange(1, rc, device=device), frame_height, rc).float()

    def cell_of(qx, qy):
        col = (qx[:, None] >= lines_x[None, :]).sum(1)
        row = (qy[:, None] >= lines_y[None, :]).sum(1)
        return torch.clamp(row, 0, rc - 1), torch.clamp(col, 0, cc - 1)

    qx, qy = px, py
    for _ in range(3):
        row, col = cell_of(qx, qy)
        qx, qy, _ = _apply_cells(table, row * cc + col, px, py)
    row0, col0 = cell_of(qx, qy)

    best_key = torch.full(px.shape, -1, dtype=torch.int64, device=device)
    best_qx = torch.full(px.shape, float(frame_width + 1), device=device)
    best_qy = torch.full(px.shape, float(frame_height + 1), device=device)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            row = row0 + dr
            col = col0 + dc
            inside = (row >= 0) & (row < rc) & (col >= 0) & (col < cc)
            key = torch.clamp(row, 0, rc - 1) * cc + torch.clamp(col, 0, cc - 1)
            cqx, cqy, h = _apply_cells(table, key, px, py)
            member = (
                (cqx > h[:, 9] - 1.0)
                & (cqx < h[:, 10] + 1.0)
                & (cqy > h[:, 11] - 1.0)
                & (cqy < h[:, 12] + 1.0)
            )
            take = member & inside & (key > best_key)
            best_key = torch.where(take, key, best_key)
            best_qx = torch.where(take, cqx, best_qx)
            best_qy = torch.where(take, cqy, best_qy)
    shape = (frame_height, frame_width)
    return BackwardMap(
        map_x=best_qx.reshape(shape),
        map_y=best_qy.reshape(shape),
        covered=(best_key >= 0).reshape(shape),
    )


def backward_map_plain(
    stab_pos: torch.Tensor,
    unstab_grid: torch.Tensor,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
) -> BackwardMap:
    """Plain backward map of one frame ((R+1, C+1, 2)) or of a batch
    ((F, R+1, C+1, 2)), one frame at a time."""
    table = cell_table(
        cell_inverse_homographies(stab_pos, unstab_grid, config),
        config, frame_height, frame_width,
    )
    if table.dim() == 2:
        return backward_map_frame_plain(table, config, frame_height, frame_width)
    maps = [
        backward_map_frame_plain(t, config, frame_height, frame_width)
        for t in table
    ]
    return BackwardMap(*(torch.stack(parts) for parts in zip(*maps)))


def bilinear_sample(
    frame: torch.Tensor,
    sample_x: torch.Tensor,
    sample_y: torch.Tensor,
    border_bgr=None,
) -> torch.Tensor:
    """Bilinear sample of (H, W, C) uint8 at float coords (...,) -> (..., C)
    float32.  border_bgr None: taps clamp to the edge (cv2.resize);
    otherwise taps outside the image read the border colour (cv2.remap
    INTER_LINEAR + BORDER_CONSTANT)."""
    h, w, c = frame.shape
    img = frame.reshape(h * w, c).to(torch.float32)
    x0 = torch.floor(sample_x)
    y0 = torch.floor(sample_y)
    fx = sample_x - x0
    fy = sample_y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    border = (
        None
        if border_bgr is None
        else torch.as_tensor(border_bgr, dtype=torch.float32, device=frame.device)
    )
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            tx = x0i + dx
            ty = y0i + dy
            weight = (fx if dx else (1.0 - fx)) * (fy if dy else (1.0 - fy))
            vals = img[torch.clamp(ty, 0, h - 1) * w + torch.clamp(tx, 0, w - 1)]
            if border is not None:
                inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
                vals = torch.where(inside[..., None], vals, border)
            out = out + weight[..., None] * vals
    return out


def warp_frame(frame: torch.Tensor, bmap: BackwardMap, border_bgr) -> torch.Tensor:
    """One stabilized uint8 frame (H, W, C) from its backward map."""
    c = frame.shape[-1]
    h, w = bmap.map_x.shape
    sampled = bilinear_sample(
        frame, bmap.map_x.reshape(-1), bmap.map_y.reshape(-1), border_bgr
    )
    border = torch.as_tensor(border_bgr, dtype=torch.float32, device=frame.device)
    sampled = torch.where(bmap.covered.reshape(-1, 1), sampled, border)
    return torch.clamp(torch.round(sampled), 0, 255).to(torch.uint8).reshape(h, w, c)


def crop_edges(bmap: BackwardMap, frame_height: int, frame_width: int) -> torch.Tensor:
    """Per-frame crop edges [left, top, right, bottom] (..., 4) int64: a
    stabilized column matches a source edge when any map entry lies within
    1 px of it; the defaults are the full frame."""
    device = bmap.map_x.device
    cols = torch.arange(frame_width, device=device)
    rows = torch.arange(frame_height, device=device)

    def extreme(match, axis, index, default, reduce_max):
        hit = match.any(dim=axis)  # (..., n)
        if reduce_max:
            best = torch.where(hit, index, torch.full_like(index, -1)).amax(-1)
        else:
            big = torch.full_like(index, max(frame_width, frame_height) + 1)
            best = torch.where(hit, index, big).amin(-1)
        return torch.where(hit.any(-1), best, torch.full_like(best, default))

    mx, my = bmap.map_x, bmap.map_y
    left = extreme(torch.abs(mx) < 1.0, -2, cols, 0, True)
    right = extreme(
        torch.abs(mx - (frame_width - 1)) < 1.0, -2, cols, frame_width - 1, False
    )
    top = extreme(torch.abs(my) < 1.0, -1, rows, 0, True)
    bottom = extreme(
        torch.abs(my - (frame_height - 1)) < 1.0, -1, rows, frame_height - 1, False
    )
    return torch.stack([left, top, right, bottom], dim=-1)


def crop_resize_frame(
    frame: torch.Tensor, crop: torch.Tensor, frame_height: int, frame_width: int
) -> torch.Tensor:
    """Crop (..., H, W, C) uint8 to [left, top, right, bottom] (inclusive)
    and stretch back to (H, W): cv2.resize INTER_LINEAR half-pixel
    sampling, clamped inside the crop."""
    device = frame.device
    left, top, right, bottom = (crop[i].to(torch.float32) for i in range(4))
    crop_w = right - left + 1.0
    crop_h = bottom - top + 1.0
    sx = crop_w / frame_width
    sy = crop_h / frame_height
    xs = (torch.arange(frame_width, dtype=torch.float32, device=device) + 0.5) * sx - 0.5
    ys = (torch.arange(frame_height, dtype=torch.float32, device=device) + 0.5) * sy - 0.5
    xs = torch.minimum(torch.clamp(xs, min=0.0), crop_w - 1.0) + left
    ys = torch.minimum(torch.clamp(ys, min=0.0), crop_h - 1.0) + top

    def taps(s, n):
        s0 = torch.floor(s)
        f = s - s0
        i0 = s0.to(torch.int64)
        return i0, torch.clamp(i0 + 1, max=n - 1), f

    y0, y1, fy = taps(ys, frame_height)
    x0, x1, fx = taps(xs, frame_width)
    img = frame.to(torch.float32)
    fy = fy[:, None, None]
    rows = (1.0 - fy) * img[..., y0, :, :] + fy * img[..., y1, :, :]
    fx = fx[:, None]
    out = (1.0 - fx) * rows[..., :, x0, :] + fx * rows[..., :, x1, :]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def render_stabilized(
    frames: torch.Tensor,
    unstab_disp: torch.Tensor,
    stab_disp: torch.Tensor,
    unstab_grid: torch.Tensor,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
):
    """Warp a block of frames and find its crop rectangle.

    frames: (F, H, W, C) uint8; *_disp: (F, R+1, C+1, 2).  Returns
    (stabilized (F, H, W, C) uint8, crop (4,) [left, top, right, bottom]).
    The backward maps come from ``kernels/bmap_cuda.backward_map``: kernel
    B for CUDA tensors, the plain version for CPU tensors.
    """
    from meshflow_tpu_torch.kernels.bmap_cuda import backward_map

    border = config.color_outside_image_area_bgr
    stab_pos = unstab_grid + (stab_disp - unstab_disp)
    bmap = backward_map(stab_pos, unstab_grid, config, frame_height, frame_width)
    stabilized = torch.stack(
        [
            warp_frame(frames[i], BackwardMap(*(m[i] for m in bmap)), border)
            for i in range(frames.shape[0])
        ]
    )
    edges = crop_edges(bmap, frame_height, frame_width)
    crop = torch.stack(
        [edges[:, 0].amax(), edges[:, 1].amax(), edges[:, 2].amin(), edges[:, 3].amin()]
    )
    return stabilized, crop


def crop_frames(
    stabilized: torch.Tensor, crop: torch.Tensor, frame_height: int, frame_width: int
) -> torch.Tensor:
    """Crop+stretch every frame back to full resolution."""
    return torch.stack(
        [crop_resize_frame(f, crop, frame_height, frame_width) for f in stabilized]
    )
