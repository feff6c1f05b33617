"""Probe E: does an 8-row-aligned dynamic band load plus a small shift
select the 16 rows at a dynamic row r0?

Ports ``scripts/probe_aligned_dynslice.py``: ``aligned_rows`` replaces
its ``kernel`` (:34), launching ``csrc/probe_aligned_dynslice.cu`` for
CUDA tensors and taking ``aligned_rows_plain`` for CPU tensors;
``aligned_rows.launches`` counts launches.  With ``base = (r0 // 8) * 8``
the 24-row band starts at ``dyn_start(base, H, 24)`` and the result is its
rows ``r0 - base .. r0 - base + 15``: ``plane[r0 : r0 + 16]`` for
0 <= r0 <= H - 17, rows above r0 below that, where the band start is
clamped and the shift is not.  The kernel takes any plane of H >= 24 rows
and W >= 4 columns with W % 4 == 0 (a direct gather of 16-byte pieces);
the wrapper raises ValueError for any other.
"""

from __future__ import annotations

import torch

from meshflow_tpu_torch.kernels._launch import launch, on_cpu, require
from meshflow_tpu_torch.probes._slices import dyn_start

H, W = 256, 256
ROWS = 16  # rows to extract
BAND = ROWS + 8
PROBE_ROW = 37  # the probe's r0

__all__ = ["H", "W", "ROWS", "PROBE_ROW", "probe_inputs", "aligned_rows", "aligned_rows_plain"]


def probe_inputs():
    """The probe's inputs, on the CPU: plane (H, W) = arange, r0 = [37]."""
    plane = torch.arange(H * W, dtype=torch.float32).reshape(H, W)
    return plane, torch.tensor([PROBE_ROW], dtype=torch.int32)


def aligned_rows_plain(plane: torch.Tensor, r0: torch.Tensor) -> torch.Tensor:
    r0 = r0.long()
    base = torch.div(r0, 8, rounding_mode="floor") * 8
    start = dyn_start(base, plane.shape[0], BAND) + (r0 - base)
    return plane[start + torch.arange(ROWS, device=plane.device)]


def aligned_rows(plane: torch.Tensor, r0: torch.Tensor) -> torch.Tensor:
    """The (16, W) rows the probe selects at r0 (an int32 tensor (1,))."""
    if on_cpu(plane, r0):
        return aligned_rows_plain(plane, r0)
    if plane.dim() != 2 or plane.shape[0] < BAND or plane.shape[1] % 4 or plane.shape[1] < 4:
        raise ValueError("aligned_rows: needs a 2-D plane of >= 24 rows and W >= 4, W % 4 == 0")
    h, w = plane.shape
    device = require("aligned_rows", (plane, torch.float32, (h, w)), (r0, torch.int32, (1,)))
    out = torch.empty(ROWS, w, dtype=torch.float32, device=device)
    launch("meshflow_probe_aligned_dynslice", device, r0, plane, out, h, w)
    aligned_rows.launches += 1
    return out


aligned_rows.launches = 0
