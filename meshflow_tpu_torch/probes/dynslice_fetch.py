"""Probe D: a per-feature band fetch against a full-plane one-hot row
select, at 1080p level-0 tile geometry (a 328 x 664 float32 plane), as the
feature block B grows.

Ports ``scripts/probe_dynslice_fetch.py``: ``dynslice_copy`` replaces
``copy_kernel`` (:40), ``dynslice_fine`` replaces ``fine_kernel`` (:57) and
``onehot_rowsel`` replaces ``onehot_kernel`` (:81).  Each launches its
kernel of ``csrc/probe_dynslice_fetch.cu`` for CUDA tensors and takes its
plain version (``*_plain``) for CPU tensors; each has a ``.launches``
count.  One call runs ``reps`` rounds (the probe's 50), and the results
are the last round's:

- ``dynslice_copy``: per round r, feature i's 48 x 256 band starts at row
  ``((idx[2i] + 8 (r % 4)) // 8) * 8`` and column
  ``((idx[2i+1] + 128 (r % 2)) // 128) * 128``, both through ``dyn_start``
  (the probe's own inputs reach past the plane and are clamped).  Returns
  (out, bands): the last band's 8 x 128 corner and the (B, 48, 256) stack.
- ``dynslice_fine``: the copy, then ``rows[b] = rsel[b] @ bands[b]``
  (40 x 48 by 48 x 256), summed in row order.  ``rsel`` (B, 40, 48) is an
  input: the probe's kernel reads a scratch that nothing writes, so its
  result is undefined.  Returns (out, bands, rows), out the last rows'
  corner.
- ``onehot_rowsel``: per round, the (B*40, W) band whose row k is
  ``plane[idx[0] + r % 4 + k % 40]`` (zero outside the plane); out sums
  the bands' 8 x 128 corners over rounds.  Returns (out, band).

Every round's band is fetched in full on the card, though only the last
one reaches an output; the copy and one-hot kernels keep ``RING`` rounds'
fetches in flight.
"""

from __future__ import annotations

import numpy as np
import torch

from meshflow_tpu_torch.kernels._launch import launch, on_cpu, require
from meshflow_tpu_torch.probes._slices import dyn_start

HPAD, WPAD = 328, 664  # a 1080p level-0 subframe tile, padded
PN = 40
BAND_R, BAND_C = PN + 8, 256
REPS = 50
SIZES = (16, 64, 128)  # the feature block sizes the probe sweeps
RING = 4  # rounds in flight in the copy and one-hot kernels (RING in the .cu)

__all__ = [
    "HPAD", "WPAD", "PN", "BAND_R", "BAND_C", "REPS", "SIZES", "RING", "probe_inputs",
    "band_index", "one_hot_rsel", "dynslice_copy", "dynslice_copy_plain", "dynslice_fine",
    "dynslice_fine_plain", "onehot_rowsel", "onehot_rowsel_plain",
]


def probe_inputs(b: int, seed: int = 0):
    """The probe's inputs for block size b, on the CPU: idx (2b,) int32 of
    8-aligned row and 128-aligned column starts, plane (HPAD, WPAD)
    float32 uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    idx = np.zeros(2 * b, np.int32)
    idx[0::2] = rng.integers(0, (HPAD - BAND_R) // 8, b) * 8
    idx[1::2] = rng.integers(0, (WPAD - BAND_C) // 128 + 1, b) * 128
    plane = rng.random((HPAD, WPAD), np.float32)
    return torch.from_numpy(idx), torch.from_numpy(plane)


def one_hot_rsel(b: int, seed: int = 0) -> torch.Tensor:
    """The fine selection the probe describes: rsel[i, p, r] = (r == p + o_i)
    with a seeded offset o_i in [0, 8), as (B, 40, 48) float32."""
    offsets = np.random.default_rng(seed).integers(0, 8, b)
    r = np.arange(BAND_R)[None, None, :]
    p = np.arange(PN)[None, :, None]
    return torch.from_numpy((r == p + offsets[:, None, None]).astype(np.float32))


def band_index(idx: torch.Tensor, r: int, h: int, w: int):
    """(rows, cols) index tensors of round r's bands, (B, 48, 1) and
    (B, 1, 256): ``plane[rows, cols]`` is the (B, 48, 256) stack."""
    i = idx.long()
    rb = torch.div(i[0::2] + 8 * (r % 4), 8, rounding_mode="floor") * 8
    cb = torch.div(i[1::2] + 128 * (r % 2), 128, rounding_mode="floor") * 128
    rows = dyn_start(rb, h, BAND_R)[:, None, None] + torch.arange(BAND_R, device=idx.device)[:, None]
    cols = dyn_start(cb, w, BAND_C)[:, None, None] + torch.arange(BAND_C, device=idx.device)
    return rows, cols


def dynslice_copy_plain(idx: torch.Tensor, plane: torch.Tensor, reps: int = REPS):
    h, w = plane.shape
    for r in range(reps):
        bands = plane[band_index(idx, r, h, w)]
    return bands[-1, 0:8, 0:128] + (reps - 1) * 0.0, bands


def dynslice_fine_plain(idx: torch.Tensor, plane: torch.Tensor, rsel: torch.Tensor,
                        reps: int = REPS):
    h, w = plane.shape
    for r in range(reps):
        bands = plane[band_index(idx, r, h, w)]
        rows = torch.zeros(bands.shape[0], PN, BAND_C, dtype=plane.dtype, device=plane.device)
        for k in range(BAND_R):
            rows = rows + rsel[:, :, k : k + 1] * bands[:, k : k + 1, :]
    return rows[-1, 0:8, 0:128] + (reps - 1) * 0.0, bands, rows


def onehot_rowsel_plain(idx: torch.Tensor, plane: torch.Tensor, reps: int = REPS):
    h = plane.shape[0]
    k = torch.arange(idx.shape[0] // 2 * PN, device=plane.device) % PN
    acc = torch.zeros(8, 128, dtype=plane.dtype, device=plane.device)
    for r in range(reps):
        t = idx[0].long() + r % 4 + k
        inside = ((t >= 0) & (t < h))[:, None]
        band = torch.where(inside, plane[t.clamp(0, h - 1)], 0.0)
        acc = acc + band[0:8, 0:128]
    return acc, band


def _geometry(name: str, idx: torch.Tensor, plane: torch.Tensor, reps: int):
    """(device, B, H, W) of a CUDA call, after its checks."""
    b = idx.numel() // 2
    if plane.dim() != 2 or b < 1 or reps < 1:
        raise ValueError(f"{name}: needs a 2-D plane, B >= 1 and reps >= 1")
    h, w = plane.shape
    if h < BAND_R or w < BAND_C or w % 4:
        raise ValueError(f"{name}: plane {h}x{w} below {BAND_R}x{BAND_C} or W % 4 != 0")
    if max(h, b * PN) * w >= 2**31:
        raise ValueError(f"{name}: plane {h}x{w} or band {b * PN}x{w} past int32 indexing")
    device = require(name, (idx, torch.int32, (2 * b,)), (plane, torch.float32, (h, w)))
    return device, b, h, w


def dynslice_copy(idx: torch.Tensor, plane: torch.Tensor, reps: int = REPS):
    """(out (8, 128), bands (B, 48, 256)) of the last of `reps` rounds."""
    if on_cpu(idx, plane):
        return dynslice_copy_plain(idx, plane, reps)
    device, b, h, w = _geometry("dynslice_copy", idx, plane, reps)
    out = torch.empty(8, 128, dtype=torch.float32, device=device)
    bands = torch.empty(b, BAND_R, BAND_C, dtype=torch.float32, device=device)
    launch("meshflow_probe_dynslice_copy", device, idx, plane, out, bands, h, w, b, reps)
    dynslice_copy.launches += 1
    return out, bands


def dynslice_fine(idx: torch.Tensor, plane: torch.Tensor, rsel: torch.Tensor,
                  reps: int = REPS):
    """(out (8, 128), bands (B, 48, 256), rows (B, 40, 256)) of the last of
    `reps` rounds."""
    if on_cpu(idx, plane, rsel):
        return dynslice_fine_plain(idx, plane, rsel, reps)
    device, b, h, w = _geometry("dynslice_fine", idx, plane, reps)
    require("dynslice_fine", (plane, torch.float32, (h, w)), (rsel, torch.float32, (b, PN, BAND_R)))
    out = torch.empty(8, 128, dtype=torch.float32, device=device)
    bands = torch.empty(b, BAND_R, BAND_C, dtype=torch.float32, device=device)
    rows = torch.empty(b, PN, BAND_C, dtype=torch.float32, device=device)
    launch("meshflow_probe_dynslice_fine", device, idx, plane, rsel, out, bands, rows,
           h, w, b, reps)
    dynslice_fine.launches += 1
    return out, bands, rows


def onehot_rowsel(idx: torch.Tensor, plane: torch.Tensor, reps: int = REPS):
    """(out (8, 128), band (B*40, W)): out sums the bands' corners over
    `reps` rounds, band is the last round's."""
    if on_cpu(idx, plane):
        return onehot_rowsel_plain(idx, plane, reps)
    device, b, h, w = _geometry("onehot_rowsel", idx, plane, reps)
    out = torch.empty(8, 128, dtype=torch.float32, device=device)
    band = torch.empty(b * PN, w, dtype=torch.float32, device=device)
    launch("meshflow_probe_onehot_rowsel", device, idx, plane, out, band, h, w, b, reps)
    onehot_rowsel.launches += 1
    return out, band


dynslice_copy.launches = 0
dynslice_fine.launches = 0
onehot_rowsel.launches = 0
