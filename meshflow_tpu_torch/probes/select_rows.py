"""Probe F: is a one-hot select of table rows exact as the row count
grows?

Ports ``scripts/probe_select_rows.py``: ``select_rows`` replaces the
kernel ``kern`` of its ``run_case`` (:39), launching
``csrc/probe_select_rows.cu`` for CUDA tensors and taking
``select_rows_plain`` for CPU tensors; ``select_rows.launches`` counts
launches.  It computes ``out[r, j] = table[r, cells[j]]`` (0 for a cell
outside the table).  The TPU formed it as a product with the one-hot of
the cells on its matrix unit; on the card it is a gather that copies each
selected value, so it is exact for every float32 table, not only for the
probe's bf16-valued pieces (the Dekker split of the backward map's cell
table).
"""

from __future__ import annotations

import numpy as np
import torch

from meshflow_tpu_torch.kernels._launch import launch, on_cpu, require

ROW_COUNTS = (48, 144, 432)  # the table heights the probe tests
CELLS_PAD = 256
BP = 7680  # cells selected per call
MAX_K = 1536  # a strip of 8 table rows stays within 48 KB of shared memory
MAX_ROWS = 8 * 65535  # strips of 8 rows on the launch's grid.y

__all__ = [
    "ROW_COUNTS", "CELLS_PAD", "BP", "general_table", "probe_inputs", "select_report",
    "select_rows", "select_rows_plain",
]


def probe_inputs(nrows: int, cells_pad: int = CELLS_PAD, bp: int = BP, seed: int = 0):
    """The probe's inputs, on the CPU: table (nrows, cells_pad) float32 of
    bf16-valued pieces spanning 1e-8..1e2, cells (1, bp) int32."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 1, (nrows, cells_pad)).astype(np.float32)
    scale = 10.0 ** rng.integers(-8, 3, (nrows, cells_pad))
    table = torch.from_numpy(base * scale).to(torch.bfloat16).to(torch.float32)
    cells = torch.from_numpy(rng.integers(0, cells_pad, (1, bp)).astype(np.int32))
    return table, cells


def general_table(nrows: int, cells_pad: int = CELLS_PAD, seed: int = 1) -> torch.Tensor:
    """(nrows, cells_pad) float32 of uniformly random bit patterns, on the
    CPU: every float32 class (NaN, infinities, subnormals, -0.0) among them."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, (nrows, cells_pad), dtype=np.uint32)
    return torch.from_numpy(bits.view(np.float32))


def select_report(got: torch.Tensor, want: torch.Tensor):
    """(exact, bad, size, max relative error) of got against want, as the
    probe prints them."""
    bad = got != want
    nz = want != 0
    rel = ((got - want)[nz] / want[nz]).abs()
    max_rel = rel.max().item() if rel.numel() else 0.0
    return bool(torch.equal(got, want)), int(bad.sum()), bad.numel(), max_rel


def select_rows_plain(table: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    k = table.shape[1]
    c = cells[0].long()
    inside = (c >= 0) & (c < k)
    return torch.where(inside, table[:, c.clamp(0, k - 1)], 0.0)


def select_rows(table: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
    """(rows, N) float32: column j is the table's column cells[0, j]."""
    if on_cpu(table, cells):
        return select_rows_plain(table, cells)
    if table.dim() != 2 or cells.dim() != 2:
        raise ValueError("select_rows: needs a 2-D table and cells of shape (1, N)")
    rows, k = table.shape
    n = cells.shape[1]
    if not 1 <= rows <= MAX_ROWS or k % 4 or not 4 <= k <= MAX_K or n % 4:
        raise ValueError(
            f"select_rows: needs 1 <= rows <= {MAX_ROWS}, K % 4 == 0 with 4 <= K <= "
            f"{MAX_K} and N % 4 == 0; got {rows} x {k}, N {n}"
        )
    device = require("select_rows", (table, torch.float32, (rows, k)), (cells, torch.int32, (1, n)))
    out = torch.empty(rows, n, dtype=torch.float32, device=device)
    launch("meshflow_probe_select_rows", device, table, cells, out, rows, k, n)
    select_rows.launches += 1
    return out


select_rows.launches = 0
