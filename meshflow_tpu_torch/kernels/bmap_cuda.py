"""Kernel B: the per-pixel backward map of the mesh warp on the card.

``backward_map`` launches ``csrc/bmap.cu`` for CUDA tensors and takes the
plain version ``backward_map_plain`` (``render/stabilize.py``) for CPU
tensors; it never falls back from one to the other.  It replaces the JAX
package's Pallas kernel ``_bmap_kernel``
(``meshflow_tpu/kernels/bmap_pallas.py:90``).  Unlike the JAX package,
which routes to its kernel only at >= 1 MP frames on a TPU (a compile-cost
rule), a CUDA tensor takes the kernel at every frame size.
``backward_map.launches`` counts kernel launches.

Both versions read the same per-cell table (``render.stabilize.cell_table``:
9 homography coefficients and the cell's bbox), computed once by PyTorch
code, so the kernel is held to the plain version's exact coverage.
"""

from __future__ import annotations

import ctypes

import torch

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels import _build
from meshflow_tpu_torch.render.stabilize import (
    BackwardMap,
    backward_map_plain,
    cell_inverse_homographies,
    cell_table,
)

__all__ = ["backward_map", "backward_map_plain"]


def backward_map(
    stab_pos: torch.Tensor,
    unstab_grid: torch.Tensor,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
) -> BackwardMap:
    """Backward map of one frame (stab_pos (R+1, C+1, 2)) or of a batch
    (F, R+1, C+1, 2); maps are (..., H, W)."""
    if stab_pos.device.type == "cpu" and unstab_grid.device.type == "cpu":
        return backward_map_plain(
            stab_pos, unstab_grid, config, frame_height, frame_width
        )
    device = stab_pos.device
    if device.type != "cuda" or unstab_grid.device != device:
        raise ValueError("backward_map: tensors must be on one CUDA device")
    rc, cc = config.mesh_row_count, config.mesh_col_count
    if (
        stab_pos.dtype != torch.float32
        or unstab_grid.dtype != torch.float32
        or stab_pos.shape[-3:] != (rc + 1, cc + 1, 2)
        or unstab_grid.shape != (rc + 1, cc + 1, 2)
        or stab_pos.dim() not in (3, 4)
    ):
        raise ValueError("backward_map: unsupported shapes or dtypes")
    single = stab_pos.dim() == 3
    pos = stab_pos[None] if single else stab_pos
    f = pos.shape[0]
    if f > 65535:
        raise ValueError("backward_map: at most 65535 frames per launch")
    table = cell_table(
        cell_inverse_homographies(pos, unstab_grid, config),
        config, frame_height, frame_width,
    ).contiguous()  # (F, cells, 13)
    shape = (f, frame_height, frame_width)
    map_x = torch.empty(shape, dtype=torch.float32, device=device)
    map_y = torch.empty(shape, dtype=torch.float32, device=device)
    covered = torch.empty(shape, dtype=torch.bool, device=device)
    lib = _build.library()
    err = lib.meshflow_bmap(
        ctypes.c_void_p(table.data_ptr()),
        ctypes.c_void_p(map_x.data_ptr()),
        ctypes.c_void_p(map_y.data_ptr()),
        ctypes.c_void_p(covered.data_ptr()),
        f, frame_height, frame_width, rc, cc,
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream),
    )
    _build.check(err, "backward_map")
    backward_map.launches += 1
    if single:
        return BackwardMap(map_x[0], map_y[0], covered[0])
    return BackwardMap(map_x, map_y, covered)


backward_map.launches = 0
