"""PyTorch port: the exactness kernel B (csrc/bmap.cu) rests on, shown on
the CPU in float32 with every product, sum and division a separate,
correctly rounded operation (as the kernel runs under --fmad=false with
IEEE division).

The kernel must give the bits of the plain version
(``backward_map_plain`` in meshflow_tpu_torch/render/stabilize.py)
although it arranges the work otherwise:

* cell(q), the number of grid lines ceil((L-1) j / n), j = 1..n-1, at or
  below q, which the plain version counts by comparisons, is computed in
  closed form with the divisor of ``bmap_cuda.axis_divisor``: swept here
  over every class of float32 q, at the lines and their neighbours, for
  meshes with repeated lines (L-1 < n) and up to 129 lines;
* the per-cell table is built by one thread per cell from scalars
  (``table_kernel``): emulated here operation by operation and held
  against ``cell_table(cell_inverse_homographies(...))``, degenerate and
  far-outside quads included (NaN positions compared as one value);
* the pixel's search stops its fixed-point steps when a step finds the
  cell of the step before, takes the candidate cells in descending
  row-major order up to the first member, and reuses the last step's
  point for the candidate that is its cell (``map_kernel``): emulated
  with the closed-form count and held against
  ``backward_map_frame_plain``, with the work counts that its
  ``return_work`` reports.
"""

import numpy as np
import pytest
import torch

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels.bmap_cuda import axis_divisor
from meshflow_tpu_torch.render.stabilize import (
    backward_map_frame_plain,
    cell_inverse_homographies,
    cell_table,
    grid_line,
)
from meshflow_tpu_torch.utils import grid
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)

F32 = np.float32


def _count_closed(q, length, n):
    """map_kernel's cell_of: 0 unless q >= 0, else
    min(n - 1, ((m n) magic >> shift) + bias), m = floor(min(q, L))."""
    magic, shift, bias = axis_divisor(length, n)
    ok = q >= 0
    m = torch.floor(torch.minimum(torch.where(ok, q, 0.0), torch.tensor(float(length))))
    k = (((m.to(torch.int64) * n) * magic) >> shift) + bias
    return torch.where(ok, torch.clamp(k, max=n - 1), 0)


def _count_compared(q, length, n):
    """The plain version's count: comparisons with every line, clamped."""
    lines = grid_line(torch.arange(1, n), length, n).float()
    return torch.clamp((q[:, None] >= lines[None, :]).sum(1), 0, n - 1)


def _sweep_values(length, n, seed):
    lines = np.ceil((length - 1) * np.arange(0, n + 1) / n).astype(F32)
    special = np.array(
        [0.0, -0.0, -0.5, -1.0, -1e-30, -1e30, 1e30, 3.4e38, np.inf, -np.inf, np.nan,
         1e-45, length, length - 1, length + 1, length - 0.5, length + 0.5],
        F32,
    )
    ints = np.arange(-2, length + 3).astype(F32)
    rng = np.random.default_rng(seed)
    values = np.concatenate([
        lines, np.nextafter(lines, F32(np.inf)), np.nextafter(lines, F32(-np.inf)),
        special, np.nextafter(special, F32(np.inf)), np.nextafter(special, F32(-np.inf)),
        ints, ints + F32(0.5),
        rng.uniform(-2, length + 2, 4096).astype(F32),
    ])
    return torch.from_numpy(values.astype(F32))


@pytest.mark.parametrize("length,n", [
    (360, 16), (640, 16), (1080, 64), (1920, 64),  # the main path and 1080p/64 meshes
    (1080, 128), (1920, 129), (720, 128), (129, 128),  # 129-line meshes
    (5, 16), (2, 64), (61, 64), (64, 129), (17, 16), (16, 16),  # L-1 <= n: repeated lines
    (1, 16), (3, 1), (16384, 1024),  # one-pixel axis, one cell, the wrapper's largest mesh
])
def test_closed_form_cell_count_equals_comparisons(length, n):
    q = _sweep_values(length, n, seed=length * 131 + n)
    assert torch.equal(_count_closed(q, length, n), _count_compared(q, length, n))


def test_axis_divisor_is_exact_up_to_its_limit():
    """floor(N / d) by multiply and shift, at the N and d the proof is
    tightest for: every d's multiples and their neighbours up to 2^31 - 1."""
    for d in (1, 2, 3, 7, 359, 639, 1079, 1919, 4095, 4097, 16383, 65535):
        magic, shift, _ = axis_divisor(d + 1, 2)
        assert magic < 2**32
        k = np.array([1, 2, 3, 1000, (2**31 - 1) // d - 1, (2**31 - 1) // d], np.int64)
        big = np.unique(np.concatenate([k * d - 1, k * d, k * d + 1, [0, 2**31 - 1]]))
        big = big[(big >= 0) & (big < 2**31)]
        got = (big.astype(object) * magic) >> shift
        assert list(got) == list(big.astype(object) // d), d


def _bits(t):
    """float32 bit patterns with every NaN as one value."""
    return torch.where(torch.isnan(t), torch.tensor(float("nan")), t).view(torch.int32)


def _unit_square_to_quad(ax, ay, bx, by, cx, cy, dx, dy):
    """table_kernel's unit_square_to_quad, scalar by scalar: returns its 9
    entries and den before the clamp."""
    s0 = ax - bx - cx + dx
    s1 = ay - by - cy + dy
    d10, d11, d20, d21 = bx - dx, by - dy, cx - dx, cy - dy
    den_raw = d10 * d21 - d11 * d20
    den = torch.where(torch.abs(den_raw) < 1e-12, torch.tensor(1e-12), den_raw)
    g = (s0 * d21 - s1 * d20) / den
    h = (d10 * s1 - d11 * s0) / den
    one = torch.ones_like(g)
    m = [bx - ax + g * bx, cx - ax + h * cx, ax, by - ay + g * by, cy - ay + h * cy, ay,
         g, h, one]
    return m, den_raw


def _table_emulated(stab_pos, unstab):
    """table_kernel for every (frame, cell) of stab_pos (F, R+1, C+1, 2):
    (F, cells, 9) coefficients, and the raw dens of the stabilized quads."""
    def corners(p):
        return [p[..., :-1, :-1, i] for i in (0, 1)] + [p[..., :-1, 1:, i] for i in (0, 1)] + [
            p[..., 1:, :-1, i] for i in (0, 1)] + [p[..., 1:, 1:, i] for i in (0, 1)]

    s, den = _unit_square_to_quad(*corners(stab_pos))
    u, _ = _unit_square_to_quad(*(c.expand_as(s[0]) for c in corners(unstab)))
    adj = [s[4] * s[8] - s[5] * s[7], s[2] * s[7] - s[1] * s[8], s[1] * s[5] - s[2] * s[4],
           s[5] * s[6] - s[3] * s[8], s[0] * s[8] - s[2] * s[6], s[2] * s[3] - s[0] * s[5],
           s[3] * s[7] - s[4] * s[6], s[1] * s[6] - s[0] * s[7], s[0] * s[4] - s[1] * s[3]]
    h = [u[3 * i] * adj[j] + u[3 * i + 1] * adj[3 + j] + u[3 * i + 2] * adj[6 + j]
         for i in range(3) for j in range(3)]
    f = stab_pos.shape[0]
    return torch.stack(h, -1).reshape(f, -1, 9), den.reshape(f, -1)


def _edges(length, n):
    """map_kernel's bbox edges of each cell along one axis, from the integer
    lines: (line - 1, next line + 1) as float32."""
    d = length - 1
    lo = torch.tensor([(d * j + n - 1) // n for j in range(n)], dtype=torch.float32) - 1.0
    hi = torch.tensor([(d * (j + 1) + n - 1) // n for j in range(n)], dtype=torch.float32) + 1.0
    return lo, hi


def _degenerate(stab, rng):
    """Vertices collapsed onto a neighbour (den 0), a cell shrunk to a
    point, three collinear vertices, and vertices pushed far outside the
    frame (up to 1e30: inf and NaN in the table)."""
    out = stab.clone()
    r, c = out.shape[-3] - 1, out.shape[-2] - 1
    out[..., 1, 1, :] = out[..., 1, 2, :]  # onto its right neighbour
    out[..., r - 1, 1, :] = out[..., r, 2, :]  # onto its diagonal neighbour
    out[..., 2, c - 1, :] = out[..., 2, c, :] = out[..., 3, c - 1, :] = out[..., 3, c, :]
    out[..., 0, 1, :] = 0.5 * (out[..., 0, 0, :] + out[..., 0, 2, :])  # collinear
    out[..., 1, 0, :] = out[..., 0, 0, :] + 1e-7  # a sliver: den far under 1e-12
    far = torch.tensor([[5e3, -7e3], [1e6, 1e6], [-1e20, 3e4], [1e30, -1e30]])
    for k, v in enumerate(far):
        out[..., r - k % r, (3 * k + 2) % (c + 1), :] = v
    out[..., r // 2, c // 2, :] += torch.from_numpy(rng.normal(0, 40, 2).astype(F32))
    return out


def _positions(mesh, h, w, sigma, frames, seed, degenerate=False, unstab_sigma=0.0):
    """Seeded corner positions; unstab_sigma moves the unstabilized grid off
    its rectangles too (the entry point takes any grid)."""
    config = MeshFlowConfig(mesh_row_count=mesh, mesh_col_count=mesh)
    rng = np.random.default_rng(seed)
    unstab = grid.vertex_grid(config, h, w)
    unstab = unstab + torch.from_numpy(rng.normal(0, unstab_sigma, unstab.shape).astype(F32))
    stab = unstab + torch.from_numpy(
        rng.normal(0, sigma, (frames,) + tuple(unstab.shape)).astype(F32))
    return config, (_degenerate(stab, rng) if degenerate else stab), unstab


@pytest.mark.parametrize("mesh,h,w,sigma,degenerate,unstab_sigma", [
    (4, 37, 53, 1.5, False, 0.0), (16, 360, 640, 1.5, False, 0.0),
    (16, 360, 640, 12.0, False, 0.0), (16, 45, 61, 3.0, True, 0.0),
    (16, 360, 640, 3.0, False, 2.0), (64, 1080, 1920, 3.0, False, 0.0),
    (64, 61, 97, 0.7, True, 0.0),
])
def test_table_emulation_equals_cell_table(mesh, h, w, sigma, degenerate, unstab_sigma):
    config, stab, unstab = _positions(mesh, h, w, sigma, 2, seed=mesh + h, degenerate=degenerate,
                                      unstab_sigma=unstab_sigma)
    want = cell_table(cell_inverse_homographies(stab, unstab, config), config, h, w)
    got, den = _table_emulated(stab, unstab)
    assert torch.equal(_bits(got), _bits(want[..., :9]))
    lo_x, hi_x = _edges(w, mesh)
    lo_y, hi_y = _edges(h, mesh)
    cols, rows = torch.arange(mesh).repeat(mesh), torch.arange(mesh).repeat_interleave(mesh)
    bbox = torch.stack([lo_x[cols] + 1.0, hi_x[cols] - 1.0, lo_y[rows] + 1.0, hi_y[rows] - 1.0], -1)
    assert torch.equal(bbox.expand_as(want[..., 9:]), want[..., 9:])
    if degenerate:  # the clamp and the far-outside vertices are reached
        assert (den.abs() < 1e-12).any() and (den == 0).any()
        assert not torch.isfinite(got).all()


def _apply(coef, cell, px, py):
    """The plain version's homography application, as apply_cell."""
    h = coef[cell]
    d = h[:, 6] * px + h[:, 7] * py + h[:, 8]
    d = torch.where(torch.abs(d) < 1e-10, torch.tensor(1e-10), d)
    return (h[:, 0] * px + h[:, 1] * py + h[:, 2]) / d, (h[:, 3] * px + h[:, 4] * py + h[:, 5]) / d


def _map_emulated(coef, mesh, h, w):
    """map_kernel for one frame of (cells, 9) coefficients: the closed-form
    count, the fixed-point steps until a step finds the cell of the step
    before, the candidates in descending row-major order up to the first
    member, the last step's point for the candidate that is its cell.
    Returns (map_x, map_y, covered) and the work counts of
    ``backward_map_frame_plain(return_work=True)``."""
    py, px = (t.reshape(-1).float() for t in torch.meshgrid(
        torch.arange(h), torch.arange(w), indexing="ij"))
    zeros = torch.zeros(px.shape, dtype=torch.int32)
    work = {"lookups": zeros, "homographies": zeros, "candidates": zeros}
    qx, qy = px, py
    qcell = torch.full(px.shape, -1)
    done = torch.zeros(px.shape, dtype=torch.bool)
    for it in range(4):
        row0, col0 = _count_closed(qy, h, mesh), _count_closed(qx, w, mesh)
        work["lookups"] = work["lookups"] + (~done).int()
        cell = row0 * mesh + col0
        done = done | (cell == qcell) | (it == 3)
        if it < 3:
            nqx, nqy = _apply(coef, cell, px, py)
            qx, qy = torch.where(done, qx, nqx), torch.where(done, qy, nqy)
            qcell = torch.where(done, qcell, cell)
            work["homographies"] = work["homographies"] + (~done).int()
    (lo_x, hi_x), (lo_y, hi_y) = _edges(w, mesh), _edges(h, mesh)
    bqx, bqy = torch.full_like(px, w + 1.0), torch.full_like(py, h + 1.0)
    found = torch.zeros(px.shape, dtype=torch.bool)
    for dr in (1, 0, -1):
        for dc in (1, 0, -1):
            row, col = row0 + dr, col0 + dc
            active = (row >= 0) & (row < mesh) & (col >= 0) & (col < mesh) & ~found
            row, col = row.clamp(0, mesh - 1), col.clamp(0, mesh - 1)
            key = row * mesh + col
            cqx, cqy = _apply(coef, key, px, py)
            cqx, cqy = torch.where(key == qcell, qx, cqx), torch.where(key == qcell, qy, cqy)
            member = (cqx > lo_x[col]) & (cqx < hi_x[col]) & (cqy > lo_y[row]) & (cqy < hi_y[row])
            take = active & member
            work["candidates"] = work["candidates"] + active.int()
            work["homographies"] = work["homographies"] + (active & (key != qcell)).int()
            bqx, bqy = torch.where(take, cqx, bqx), torch.where(take, cqy, bqy)
            found |= take
    maps = bqx.reshape(h, w), bqy.reshape(h, w), found.reshape(h, w)
    return maps, {k: v.reshape(h, w) for k, v in work.items()}


@pytest.mark.parametrize("mesh,h,w,sigma,degenerate", [
    (4, 37, 53, 1.5, False), (4, 41, 59, 6.0, False), (16, 45, 61, 1.5, False),
    (16, 45, 61, 12.0, False), (16, 47, 67, 3.0, True), (64, 61, 97, 0.7, False),
    (64, 71, 131, 0.5, True),
])
def test_map_emulation_equals_plain(mesh, h, w, sigma, degenerate):
    config, stab, unstab = _positions(mesh, h, w, sigma, 2, seed=7 * mesh + h,
                                      degenerate=degenerate)
    coef, _ = _table_emulated(stab, unstab)
    table = cell_table(cell_inverse_homographies(stab, unstab, config), config, h, w)
    uncovered, steps = 0, set()
    for f in range(stab.shape[0]):
        want, want_work = backward_map_frame_plain(table[f], config, h, w, return_work=True)
        got, got_work = _map_emulated(coef[f], mesh, h, w)
        for g, p in zip(got, want):
            assert torch.equal(g, p)
        for name in want_work:
            assert torch.equal(got_work[name], want_work[name]), name
        uncovered += int((~want.covered).sum())
        steps |= set((want_work["lookups"] - 1).unique().tolist())
    assert uncovered > 0 or sigma < 3.0  # the heavy warps reach the sentinel
    assert steps >= {1, 2}  # the fixed-point search stops early and goes on
