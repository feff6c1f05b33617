"""Mesh-vertex and subframe geometry.

The vertex grid uses the reference's ceil placement rule
``x = ceil((W-1) * col / C)``, ``y = ceil((H-1) * row / R)``; subframes are
visited in the reference's order (outer loop over x, inner over y).
"""

from __future__ import annotations

import numpy as np
import torch

from meshflow_tpu_torch.config import MeshFlowConfig


def vertex_grid(
    config: MeshFlowConfig, frame_height: int, frame_width: int, device="cpu"
) -> torch.Tensor:
    """float32 (vertex_rows, vertex_cols, 2) [x, y] vertex coordinates."""
    rows = np.arange(config.vertex_rows)
    cols = np.arange(config.vertex_cols)
    x = np.ceil((frame_width - 1) * cols / config.mesh_col_count)
    y = np.ceil((frame_height - 1) * rows / config.mesh_row_count)
    xx, yy = np.meshgrid(x, y)
    grid = np.stack([xx, yy], axis=-1).astype(np.float32)
    return torch.from_numpy(grid).to(device)


def subframe_offsets(
    config: MeshFlowConfig, frame_height: int, frame_width: int, device="cpu"
) -> torch.Tensor:
    """int32 (num_subframes, 2) [x, y] top-left corner of each subframe."""
    sub_h, sub_w = config.subframe_shape(frame_height, frame_width)
    offsets = [
        (x, y)
        for x in range(0, frame_width, sub_w)
        for y in range(0, frame_height, sub_h)
    ]
    return torch.tensor(offsets, dtype=torch.int32, device=device)
