"""Probe G: how a per-feature scalar (a band base) is handed from a value
computed in the kernel to an address.

Ports ``scripts/probe_scalar_from_vmem.py``: ``band_row`` replaces its
``kernel`` (:35), launching ``csrc/probe_scalar_from_vmem.cu`` for CUDA
tensors and taking ``band_row_plain`` for CPU tensors;
``band_row.launches`` counts launches.  For each feature i,
``v = 2 * corners[i, 0] + 1`` (float32), ``base = (floor(v) // 8) * 8`` and
the result's row i is ``plane[dyn_start(base, H, 16)]``: a base past
``H - 16`` is clamped, a negative one wrapped by H first, as the probe's
Pallas kernel takes them.  On the card each thread computes its
feature's base itself and copies one float4 of the row; ``pdl`` launches
the kernel programmatically (``csrc/probe_scalar_from_vmem.cu``).
``launch_floor`` launches an empty kernel of the same grid, the same way,
for the card's back-to-back launch floor.
"""

from __future__ import annotations

import numpy as np
import torch

from meshflow_tpu_torch.kernels._launch import launch, on_cpu, require
from meshflow_tpu_torch.probes._slices import dyn_start

H, W = 64, 256
B = 8
ROWS = 16  # the probe's band height; only its first row is kept
LANES = 128  # corners are (B, 128); column 0 holds the corner

THREADS = 256  # the kernel's block size
PDL = True  # launch programmatically by default

__all__ = ["H", "W", "B", "probe_inputs", "corners_from", "band_row", "band_row_plain",
           "launch_floor"]


def probe_inputs(seed: int = 0):
    """The probe's inputs, on the CPU: plane (H, W) float32 uniform in
    [0, 1), corners (B, 128) float32 with integer corners in [0, 24) in
    column 0."""
    rng = np.random.default_rng(seed)
    plane = rng.random((H, W), np.float32)
    corners = rng.integers(0, (H - ROWS) // 2, (B, 1)).astype(np.float32)
    return torch.from_numpy(plane), corners_from(corners[:, 0])


def corners_from(values) -> torch.Tensor:
    """(len(values), 128) float32 corners with `values` in column 0."""
    values = np.asarray(values, np.float32)
    out = np.zeros((values.size, LANES), np.float32)
    out[:, 0] = values
    return torch.from_numpy(out)


def band_row_plain(plane: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    v = corners[:, 0] * 2.0 + 1.0
    base = torch.div(torch.floor(v).to(torch.int64), 8, rounding_mode="floor") * 8
    return plane[dyn_start(base, plane.shape[0], ROWS)][:, None, :]


def band_row(plane: torch.Tensor, corners: torch.Tensor, pdl: bool = PDL) -> torch.Tensor:
    """(B, 1, W): row i is the plane row at feature i's band base.  `pdl`:
    launch the kernel programmatically (card only)."""
    if on_cpu(plane, corners):
        return band_row_plain(plane, corners)
    if plane.dim() != 2 or corners.dim() != 2:
        raise ValueError("band_row: needs a 2-D plane and 2-D corners")
    (h, w), (b, ldc) = plane.shape, corners.shape
    if h < ROWS or w % 4 or not 1 <= b <= 32:
        raise ValueError(f"band_row: needs H >= {ROWS}, W % 4 == 0 and 1 <= B <= 32; "
                         f"got plane {h}x{w}, B {b}")
    device = require("band_row", (plane, torch.float32, (h, w)), (corners, torch.float32, (b, ldc)))
    out = torch.empty(b, 1, w, dtype=torch.float32, device=device)
    launch("meshflow_probe_scalar_from_vmem", device, plane, corners, out, h, w, b, ldc,
           int(pdl))
    band_row.launches += 1
    return out


band_row.launches = 0


def launch_floor(b: int = B, w: int = W, pdl: bool = PDL, device="cuda") -> None:
    """Launch an empty kernel of `band_row`'s grid for B = `b` and W = `w`,
    the way `band_row` launches (card only; not counted in launches)."""
    blocks = -(-b * (w // 4) // THREADS)
    launch("meshflow_probe_launch_floor", torch.device(device), blocks, int(pdl))
