"""Pyramidal Lucas-Kanade, one pyramid level: the plain PyTorch version.

The semantics of cv2.calcOpticalFlowPyrLK with OpenCV's defaults, as the
JAX package's tracker (``meshflow_tpu/kernels/lk.py:1-45`` and its Pallas
kernel ``_lk_pallas_onehot.py``) reproduces them:

* Scharr/32 derivatives of the previous level, REFLECT_101 image border,
  derivatives zero outside the level;
* the previous window (image, gx, gy) is sampled bilinearly once per level
  and frozen, and so is its 2x2 gradient matrix;
* each iteration samples the next window at the current estimate and
  steps by -A^-1 b, stopping at |delta|^2 <= eps^2, after 30 iterations,
  or on oscillation (|delta + prev_delta| < 0.01 per component: back off
  half a step);
* a feature whose window corner leaves [-21, size) stops; status goes to
  False only at level 0 (out of bounds, or minEig/winArea below the
  threshold in OpenCV's scaling, or det < FLT_EPSILON);
* slots that are not valid pass through untouched.

Every window read is a plain gather from the level plane, REFLECT_101-
padded by ``PAD``.  The Pallas kernel's patch re-fetch rounds exist only
because of the TPU's fast-memory size and are not carried over: a feature
iterates on the whole plane until it stops.

This module is the reference the CUDA kernel (``lk_cuda.py``,
``csrc/lk_level.cu``) is held against, and the path a CPU tensor takes.
The bilinear weights, Scharr sums and the update follow the same order
of operations as the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

WIN = 21  # OpenCV default window
HALF = (WIN - 1) * 0.5
PAD = 28  # REFLECT_101 plane padding; a window corner lies in [-21, size)
CV_SCALE = 1.0 / 1024.0  # Scharr is 32x the unit gradient; OpenCV's FLT_SCALE
FLT_EPSILON = 1.19209290e-07

# Feature slots tracked together: bounds the (n, C, 24, 24) window
# tensors to ~60 MB per chunk at C=3.
_CHUNK = 8192


def _reflect_indices(h: int, w: int, pad: int):
    """Index maps of a REFLECT_101 pad by `pad`, applied in steps of at
    most min(size)-1 like numpy's "reflect" (and the JAX package)."""
    iy, ix = np.arange(h), np.arange(w)
    remaining = pad
    while remaining > 0:
        step = min(remaining, min(len(iy), len(ix)) - 1)
        iy = np.pad(iy, step, mode="reflect")
        ix = np.pad(ix, step, mode="reflect")
        remaining -= step
    return iy, ix


def reflect_pad_level(img: torch.Tensor, pad: int = PAD) -> torch.Tensor:
    """REFLECT_101-pad the last two dims of any tensor by `pad`."""
    iy, ix = _reflect_indices(img.shape[-2], img.shape[-1], pad)
    iy = torch.from_numpy(iy).to(img.device)
    ix = torch.from_numpy(ix).to(img.device)
    return img.index_select(-2, iy).index_select(-1, ix)


def _windows(planes, plane_idx, y0, x0, size):
    """(n, C, size, size) float32 patches of planes (P, C, Hp, Wp) at
    per-feature top-left corners (y0, x0) on the padded axes."""
    c = planes.shape[1]
    r = torch.arange(size, device=planes.device)
    rows = (y0[:, None] + r)[:, None, :, None]
    cols = (x0[:, None] + r)[:, None, None, :]
    ch = torch.arange(c, device=planes.device)[None, :, None, None]
    return planes[plane_idx[:, None, None, None], ch, rows, cols].to(torch.float32)


def _bilinear(v, fy, fx):
    """(n, C, 22, 22) taps -> (n, C, 21, 21) window: rows first, then
    columns, (1-f)*lo + f*hi at each step."""
    fy = fy[:, None, None, None]
    fx = fx[:, None, None, None]
    row = (1.0 - fy) * v[:, :, :WIN, :] + fy * v[:, :, 1 : WIN + 1, :]
    return (1.0 - fx) * row[..., :WIN] + fx * row[..., 1 : WIN + 1]


def _scharr(p):
    """Scharr/32 at the 22x22 interior of (n, C, 24, 24) patches."""
    n = WIN + 1

    def at(dy, dx):
        return p[:, :, 1 + dy : 1 + dy + n, 1 + dx : 1 + dx + n]

    gx = (
        3.0 * (at(-1, 1) - at(-1, -1))
        + 10.0 * (at(0, 1) - at(0, -1))
        + 3.0 * (at(1, 1) - at(1, -1))
    ) * (1.0 / 32.0)
    gy = (
        3.0 * (at(1, -1) - at(-1, -1))
        + 10.0 * (at(1, 0) - at(-1, 0))
        + 3.0 * (at(1, 1) - at(-1, 1))
    ) * (1.0 / 32.0)
    return gx, gy


def _in_bounds(ix, iy, rows, cols):
    return (ix >= -WIN) & (ix < cols) & (iy >= -WIN) & (iy < rows)


def _track_chunk(
    prev_flat, next_flat, pidx, nidx, pts, guess, status, rows, cols,
    max_iters, eps, min_eig_threshold, is_level0,
):
    """Track n valid slots through one level; returns (corner, status)."""
    hpad, wpad = prev_flat.shape[-2], prev_flat.shape[-1]
    ipx_f = torch.floor(pts[:, 0])
    ipy_f = torch.floor(pts[:, 1])
    a = pts[:, 0] - ipx_f
    b = pts[:, 1] - ipy_f
    ipx = ipx_f.to(torch.int64)
    ipy = ipy_f.to(torch.int64)
    inb_prev = _in_bounds(ipx, ipy, rows, cols)

    # 24x24 prev patch: padded rows ipy+PAD-1 .. ipy+PAD+22 (clamped only
    # for features that are out of bounds and never iterate).
    y0 = torch.clamp(ipy + PAD - 1, 0, hpad - 24)
    x0 = torch.clamp(ipx + PAD - 1, 0, wpad - 24)
    patch = _windows(prev_flat, pidx, y0, x0, 24)
    gx, gy = _scharr(patch)
    # derivatives are zero outside the level extent
    r = torch.arange(WIN + 1, device=pts.device)
    ry = y0[:, None] + 1 + r - PAD
    rx = x0[:, None] + 1 + r - PAD
    mask = (((ry >= 0) & (ry < rows))[:, :, None] & ((rx >= 0) & (rx < cols))[:, None, :])
    mask = mask[:, None].to(torch.float32)
    iwin = _bilinear(patch[:, :, 1:23, 1:23], b, a)
    gxwin = _bilinear(gx * mask, b, a)
    gywin = _bilinear(gy * mask, b, a)

    a11 = (gxwin * gxwin).sum((1, 2, 3)) * CV_SCALE
    a12 = (gxwin * gywin).sum((1, 2, 3)) * CV_SCALE
    a22 = (gywin * gywin).sum((1, 2, 3)) * CV_SCALE
    det = a11 * a22 - a12 * a12
    min_eig = (a22 + a11 - torch.sqrt((a11 - a22) ** 2 + 4.0 * a12 * a12)) / (
        2.0 * WIN * WIN
    )
    well_posed = (min_eig >= min_eig_threshold) & (det >= FLT_EPSILON)
    inv_det = torch.where(det == 0.0, torch.zeros_like(det), 1.0 / det)
    if is_level0:
        status = status & inb_prev & well_posed

    active = inb_prev & well_posed
    corner = guess.clone()
    prev_delta = torch.zeros_like(corner)
    eps2 = eps * eps
    for j in range(max_iters):
        if not bool(active.any()):
            break
        icx_f = torch.floor(corner[:, 0])
        icy_f = torch.floor(corner[:, 1])
        fa = corner[:, 0] - icx_f
        fb = corner[:, 1] - icy_f
        icx = icx_f.to(torch.int64)
        icy = icy_f.to(torch.int64)
        inb = _in_bounds(icx, icy, rows, cols)
        if is_level0:
            status = status & (inb | ~active)
        still = active & inb
        jy = torch.clamp(icy + PAD, 0, hpad - 22)
        jx = torch.clamp(icx + PAD, 0, wpad - 22)
        jwin = _bilinear(_windows(next_flat, nidx, jy, jx, 22), fb, fa)
        diff = jwin - iwin
        b1 = (diff * gxwin).sum((1, 2, 3)) * CV_SCALE
        b2 = (diff * gywin).sum((1, 2, 3)) * CV_SCALE
        dx = (a12 * b2 - a22 * b1) * inv_det
        dy = (a12 * b1 - a11 * b2) * inv_det
        delta = torch.stack([dx, dy], dim=-1)
        new_corner = torch.where(still[:, None], corner + delta, corner)
        converged = (dx * dx + dy * dy) <= eps2
        oscillating = (
            (j > 0)
            & (torch.abs(dx + prev_delta[:, 0]) < 0.01)
            & (torch.abs(dy + prev_delta[:, 1]) < 0.01)
        )
        corner = torch.where(
            (still & oscillating)[:, None], new_corner - delta * 0.5, new_corner
        )
        exhausted = j + 1 >= max_iters
        active = still & ~converged & ~oscillating & (not exhausted)
        prev_delta = delta
    return corner, status


def lk_level_plain(
    prev_planes: torch.Tensor,
    next_planes: torch.Tensor,
    pts: torch.Tensor,
    guess: torch.Tensor,
    valid: torch.Tensor,
    status_in: torch.Tensor,
    rows: int,
    cols: int,
    shifted: bool = True,
    max_iters: int = 30,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-4,
    is_level0: bool = False,
):
    """One pyramid level for every (pair, tile, feature) slot.

    prev_planes, next_planes: (F, S, C, rows+2*PAD, cols+2*PAD) uint8,
    REFLECT_101-padded.  shifted=True tracks pair t from prev plane t into
    next plane t+1 (pass the same array twice); shifted=False from prev
    plane t into next plane t of the second array.
    pts: (T, S, K, 2) float32 prev window corners at this level (position
    minus HALF); guess: (T, S, K, 2) next-corner estimates; valid,
    status_in: (T, S, K) bool.  Returns (corners (T, S, K, 2), status).
    """
    t, s, k, _ = pts.shape
    c, hpad, wpad = prev_planes.shape[2:]
    prev_flat = prev_planes.reshape(-1, c, hpad, wpad)
    next_flat = next_planes.reshape(-1, c, hpad, wpad)
    corner = guess.reshape(-1, 2).clone()
    status = status_in.reshape(-1).clone()
    slots = torch.nonzero(valid.reshape(-1)).reshape(-1)
    shift = 1 if shifted else 0
    pts_flat = pts.reshape(-1, 2)
    for start in range(0, slots.numel(), _CHUNK):
        idx = slots[start : start + _CHUNK]
        pair = idx // (s * k)
        tile = (idx // k) % s
        c_out, st_out = _track_chunk(
            prev_flat, next_flat,
            pair * s + tile, (pair + shift) * s + tile,
            pts_flat[idx], corner[idx], status[idx], rows, cols,
            max_iters, eps, min_eig_threshold, is_level0,
        )
        corner[idx] = c_out
        status[idx] = st_out
    return corner.reshape(t, s, k, 2), status.reshape(t, s, k)
