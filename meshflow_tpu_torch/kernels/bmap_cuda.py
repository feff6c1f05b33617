"""Kernel B: the per-pixel backward map of the mesh warp on the card.

``backward_map`` launches ``csrc/bmap.cu`` for CUDA tensors and takes the
plain version ``backward_map_plain`` (``render/stabilize.py``) for CPU
tensors; it never falls back from one to the other.  It replaces the JAX
package's Pallas kernel ``_bmap_kernel``
(``meshflow_tpu/kernels/bmap_pallas.py:90``).  Unlike the JAX package,
which routes to its kernel only at >= 1 MP frames on a TPU (a compile-cost
rule), a CUDA tensor takes the kernel at every frame size.
``backward_map.launches`` counts calls of the kernel's entry point.

Both versions start from the mesh's corner positions.  The plain version
builds the per-cell table (``cell_table`` of ``cell_inverse_homographies``)
with PyTorch ops; the kernel's entry point builds it on the card in a
first launch, with the plain version's operations in the same order, and
then maps every pixel.  On a CUDA tensor the wrapper runs no PyTorch op
besides allocating the outputs and the table's workspace.
"""

from __future__ import annotations

import functools

import torch

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels import _launch
from meshflow_tpu_torch.render.stabilize import BackwardMap, backward_map_plain

__all__ = ["axis_divisor", "backward_map", "backward_map_plain"]

TABLE_FLOATS = 12  # a cell's 9 coefficients, padded to three 16-byte loads
MAX_FRAMES = 65535  # the map launch's grid.z
MAX_MESH = 1024  # cells a side: the bbox edges fit a block's shared memory


@functools.cache
def axis_divisor(length: int, cells: int) -> tuple[int, int, int]:
    """(magic, shift, bias) with which the kernel counts the grid lines
    ceil((length-1) j / cells), j = 1..cells-1, at or below a float q >= 0:
    min(cells - 1, ((m * cells) * magic >> shift) + bias), m = floor(min(q,
    length)).  That is floor(m cells / (length-1)), exact for m cells <
    2^31: magic = ceil(2^shift / d), d = length-1, so magic d - 2^shift <
    d <= 2^(shift-31).  For length 1 every line is 0 and the count is
    cells - 1 (bias)."""
    d = length - 1
    if d == 0:
        return 0, 0, cells - 1
    shift = 31 + (d - 1).bit_length()  # 2^(shift-31) >= d, magic < 2^32
    return -(-(1 << shift) // d), shift, 0


def backward_map(
    stab_pos: torch.Tensor,
    unstab_grid: torch.Tensor,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
) -> BackwardMap:
    """Backward map of one frame (stab_pos (R+1, C+1, 2)) or of a batch
    (F, R+1, C+1, 2); maps are (..., H, W)."""
    if _launch.on_cpu(stab_pos, unstab_grid):
        return backward_map_plain(
            stab_pos, unstab_grid, config, frame_height, frame_width
        )
    rc, cc = config.mesh_row_count, config.mesh_col_count
    single = stab_pos.dim() == 3
    f = stab_pos.shape[0] if stab_pos.dim() == 4 else 1
    device = stab_pos.device
    for t, shape in ((stab_pos, (f, rc + 1, cc + 1, 2)[single:]),
                     (unstab_grid, (rc + 1, cc + 1, 2))):
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"backward_map: tensors must be on one CUDA device, got {t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"backward_map: expected a contiguous float32 tensor of shape {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    if f > MAX_FRAMES or max(rc, cc) > MAX_MESH:
        raise ValueError(
            f"backward_map: at most {MAX_FRAMES} frames and {MAX_MESH} cells a side "
            f"per launch, got {f} frames, mesh {rc}x{cc}"
        )
    if frame_height * rc >= 2**31 or frame_width * cc >= 2**31:
        raise ValueError("backward_map: frame too large for the kernel's cell count")
    shape = (frame_height, frame_width) if single else (f, frame_height, frame_width)
    map_x = torch.empty(shape, dtype=torch.float32, device=device)
    map_y = torch.empty(shape, dtype=torch.float32, device=device)
    covered = torch.empty(shape, dtype=torch.bool, device=device)
    table = torch.empty(f * rc * cc * TABLE_FLOATS, dtype=torch.float32, device=device)
    _launch.launch(
        "meshflow_bmap", device, stab_pos, unstab_grid, table, map_x, map_y, covered,
        f, frame_height, frame_width, rc, cc,
        *axis_divisor(frame_height, rc), *axis_divisor(frame_width, cc),
    )
    _launch.count(backward_map)
    return BackwardMap(map_x, map_y, covered)


backward_map.launches = 0
