# Frozen copy of meshflow_tpu_torch/kernels/lk.py, plain PyTorch route only.
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

The port holds its CUDA kernels against this module.  Here the
iterations run on the slots still active only, and in larger chunks, so
that the benchmark's comparison runs in seconds on the card; each slot's
arithmetic is unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import precision

WIN = 21  # OpenCV default window
HALF = (WIN - 1) * 0.5
PAD = 28  # REFLECT_101 plane padding; a window corner lies in [-21, size)
CV_SCALE = 1.0 / 1024.0  # Scharr is 32x the unit gradient; OpenCV's FLT_SCALE
FLT_EPSILON = 1.19209290e-07

# Feature slots tracked together: bounds the (n, C, 24, 24) window
# tensors to ~2 GB per chunk at C=3 (the reference runs after the
# program's state is freed).
_CHUNK = 262144


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


@functools.cache
def _reflect_index_tensors(h: int, w: int, pad: int, device: torch.device):
    """``_reflect_indices`` on `device`, made once a shape and device and
    kept (read only): a CUDA graph that pads copies nothing from the host."""
    iy, ix = _reflect_indices(h, w, pad)
    return torch.from_numpy(iy).to(device), torch.from_numpy(ix).to(device)


def reflect_pad_level(img: torch.Tensor, pad: int = PAD) -> torch.Tensor:
    """REFLECT_101-pad the last two dims of any tensor by `pad`."""
    iy, ix = _reflect_index_tensors(img.shape[-2], img.shape[-1], pad, img.device)
    return img.index_select(-2, iy).index_select(-1, ix)


def _windows(planes, plane_idx, y0, x0, size):
    """(n, C, size, size) float32 patches of planes (P, C, Hp, Wp) at
    per-feature top-left corners (y0, x0) on the padded axes."""
    c = planes.shape[1]
    r = torch.arange(size, device=planes.device)
    rows = (y0[:, None] + r)[:, None, :, None]
    cols = (x0[:, None] + r)[:, None, None, :]
    ch = torch.arange(c, device=planes.device)[None, :, None, None]
    return planes[plane_idx[:, None, None, None], ch, rows, cols].to(precision.IMAGE)


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
    """Track n valid slots through one level; returns (corner, status,
    iterations): iterations counts the steps each slot took (window reads
    of the next image)."""
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
    mask = mask[:, None].to(precision.IMAGE)
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

    # The iterations run on the slots still active only (compacted each
    # iteration); a slot's arithmetic is that of the port's masked loop.
    corner = guess.clone()
    prev_delta = torch.zeros_like(corner)
    iterations = torch.zeros(corner.shape[0], dtype=torch.int32, device=corner.device)
    act = torch.nonzero(inb_prev & well_posed).reshape(-1)
    eps2 = eps * eps
    for j in range(max_iters):
        if act.numel() == 0:
            break
        cur = corner[act]
        icx_f = torch.floor(cur[:, 0])
        icy_f = torch.floor(cur[:, 1])
        fa = cur[:, 0] - icx_f
        fb = cur[:, 1] - icy_f
        icx = icx_f.to(torch.int64)
        icy = icy_f.to(torch.int64)
        inb = _in_bounds(icx, icy, rows, cols)
        if is_level0:
            status[act] = status[act] & inb
        iterations[act] += inb.to(torch.int32)
        jy = torch.clamp(icy + PAD, 0, hpad - 22)
        jx = torch.clamp(icx + PAD, 0, wpad - 22)
        jwin = _bilinear(_windows(next_flat, nidx[act], jy, jx, 22), fb, fa)
        diff = jwin - iwin[act]
        b1 = (diff * gxwin[act]).sum((1, 2, 3)) * CV_SCALE
        b2 = (diff * gywin[act]).sum((1, 2, 3)) * CV_SCALE
        a11a, a12a, a22a, inv = a11[act], a12[act], a22[act], inv_det[act]
        dx = (a12a * b2 - a22a * b1) * inv
        dy = (a12a * b1 - a11a * b2) * inv
        delta = torch.stack([dx, dy], dim=-1)
        new_corner = torch.where(inb[:, None], cur + delta, cur)
        converged = (dx * dx + dy * dy) <= eps2
        pd = prev_delta[act]
        oscillating = (
            (j > 0)
            & (torch.abs(dx + pd[:, 0]) < 0.01)
            & (torch.abs(dy + pd[:, 1]) < 0.01)
        )
        corner[act] = torch.where(
            (inb & oscillating)[:, None], new_corner - delta * 0.5, new_corner
        )
        prev_delta[act] = delta
        if j + 1 >= max_iters:
            break
        act = act[inb & ~converged & ~oscillating]
    return corner, status, iterations


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
    return_iters: bool = False,
):
    """One pyramid level for every (pair, tile, feature) slot.

    prev_planes, next_planes: (F, S, C, rows+2*PAD, cols+2*PAD) uint8,
    REFLECT_101-padded.  shifted=True tracks pair t from prev plane t into
    next plane t+1 (pass the same array twice); shifted=False from prev
    plane t into next plane t of the second array.
    pts: (T, S, K, 2) float32 prev window corners at this level (position
    minus HALF); guess: (T, S, K, 2) next-corner estimates; valid,
    status_in: (T, S, K) bool.  Returns (corners (T, S, K, 2), status),
    and with return_iters also the steps each slot took ((T, S, K) int32,
    the count a kernel's loop runs on the same inputs).
    """
    t, s, k, _ = pts.shape
    c, hpad, wpad = prev_planes.shape[2:]
    prev_flat = prev_planes.reshape(-1, c, hpad, wpad)
    next_flat = next_planes.reshape(-1, c, hpad, wpad)
    corner = guess.reshape(-1, 2).clone()
    status = status_in.reshape(-1).clone()
    iterations = torch.zeros(status.shape, dtype=torch.int32, device=status.device)
    slots = torch.nonzero(valid.reshape(-1)).reshape(-1)
    shift = 1 if shifted else 0
    pts_flat = pts.reshape(-1, 2)
    for start in range(0, slots.numel(), _CHUNK):
        idx = slots[start : start + _CHUNK]
        pair = idx // (s * k)
        tile = (idx // k) % s
        c_out, st_out, it_out = _track_chunk(
            prev_flat, next_flat,
            pair * s + tile, (pair + shift) * s + tile,
            pts_flat[idx], corner[idx], status[idx], rows, cols,
            max_iters, eps, min_eig_threshold, is_level0,
        )
        corner[idx] = c_out
        status[idx] = st_out
        iterations[idx] = it_out
    if work is not None:
        same = prev_planes.data_ptr() == next_planes.data_ptr()
        work.append({
            "channels": c,
            "setups": int(slots.numel()),
            "steps": int(iterations.sum()),
            "plane_bytes": prev_planes.numel() + (0 if same else next_planes.numel()),
            "slots": valid.numel(),
        })
    out = (corner.reshape(t, s, k, 2), status.reshape(t, s, k))
    return out + (iterations.reshape(t, s, k),) if return_iters else out


# When a list, every level call appends the work its inputs needed: the
# slots set up, the steps they took, the planes' bytes and the slot count
# (portbench/roofline.py turns them into a bound).
work: list | None = None


def lk_track_parallel(
    prev_levels,
    next_levels,
    level_dims,
    pts: torch.Tensor,
    valid: torch.Tensor,
    shifted: bool = False,
    max_iters: int = 30,
    eps: float = 0.01,
    min_eig_threshold: float = 1e-4,
    init_pts: torch.Tensor | None = None,
):
    """Track pts of prev pyramid t into next pyramid t (t+1 if shifted),
    coarse to fine: the top level starts at the source position (or
    init_pts), guesses double between levels, status demotes only at
    level 0, and slots that are not valid come back with their input
    position and status False.  Frozen copy of the port's
    ``kernels/lk_cuda.lk_track_parallel`` on ``lk_level_plain``."""
    max_level = len(prev_levels) - 1
    status = valid
    start = pts if init_pts is None else init_pts
    next_pts = start / (2.0**max_level)
    for level in range(max_level, -1, -1):
        rows_l, cols_l = level_dims[level]
        prev_l = pts / (2.0**level) - HALF
        if level != max_level:
            next_pts = next_pts * 2.0
        corner, status = lk_level_plain(
            prev_levels[level],
            next_levels[level],
            prev_l,
            next_pts - HALF,
            valid,
            status,
            rows=rows_l,
            cols=cols_l,
            shifted=shifted,
            max_iters=max_iters,
            eps=eps,
            min_eig_threshold=min_eig_threshold,
            is_level0=(level == 0),
        )
        next_pts = corner + HALF
    out = torch.where(valid[..., None], next_pts, pts)
    return out, status & valid
