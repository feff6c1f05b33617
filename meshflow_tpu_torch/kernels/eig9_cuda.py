"""eig9: the DLT's null vector on the card, without a host sync.

``null_vector`` launches ``csrc/eig9.cu`` for a CUDA tensor and takes the
plain version ``null_vector_plain`` (``torch.linalg.eigh``) for a CPU
tensor; it never falls back from one to the other.  It has no TPU
counterpart: the JAX package takes a float32 SVD of the weighted design
matrix (``meshflow_tpu/kernels/homography.py:74`` ``dlt_homography``).  The
port forms the 9x9 normal matrix in float64 instead (``dlt_homography``),
and ``eigh`` synchronizes the host with the card for CUDA inputs, which no
CUDA graph can capture.  ``null_vector.launches`` counts kernel launches.

``null_vector_jacobi`` repeats the kernel's cyclic Jacobi sweeps in
PyTorch float64, operation for operation in the kernel's order, batched
over the matrices: the tests hold it against ``eigh`` on the CPU, and on
the card the kernel is held against both; its sweep counts give the
kernel's bound.
"""

from __future__ import annotations

import torch

from meshflow_tpu_torch.kernels import _launch

__all__ = ["MAX_SWEEPS", "TOL2", "null_vector", "null_vector_jacobi", "null_vector_plain"]

N = 9
MAX_SWEEPS = 20  # csrc/eig9.cu
TOL2 = 1e-30  # a sweep starts while off-diagonal squares > TOL2 * all squares


def null_vector_plain(normal: torch.Tensor) -> torch.Tensor:
    """(..., 9, 9) symmetric float64 -> (..., 9): the unit eigenvector of
    the smallest eigenvalue, from the lower triangle."""
    return torch.linalg.eigh(normal)[1][..., 0]


def null_vector(normal: torch.Tensor) -> torch.Tensor:
    """``null_vector_plain`` of (..., 9, 9) float64 matrices: the kernel on
    the card, eigh on the CPU."""
    if _launch.on_cpu(normal):
        return null_vector_plain(normal)
    batch = normal.shape[:-2]
    flat = normal.reshape(-1, N, N).contiguous()
    count = flat.shape[0]
    device = _launch.require("eig9", (flat, torch.float64, (count, N, N)))
    out = torch.empty((count, N), dtype=torch.float64, device=device)
    if count:
        _launch.launch("meshflow_eig9", device, flat, out, count)
        _launch.count(null_vector)
    return out.reshape(batch + (N,))


null_vector.launches = 0


def null_vector_jacobi(normal: torch.Tensor, return_sweeps: bool = False):
    """The kernel's arithmetic in PyTorch: (..., 9, 9) float64 -> (..., 9)
    (and the sweeps each matrix took, int32, with return_sweeps)."""
    batch = normal.shape[:-2]
    flat = normal.reshape(-1, N, N)
    rows = torch.arange(N, device=flat.device)
    a = torch.where(rows[:, None] >= rows[None, :], flat, flat.transpose(-1, -2))
    v = torch.eye(N, dtype=a.dtype, device=a.device).expand_as(a).clone()
    count = a.shape[0]
    active = torch.ones(count, dtype=torch.bool, device=a.device)
    sweeps = torch.zeros(count, dtype=torch.int32, device=a.device)
    for _ in range(MAX_SWEEPS):
        off = torch.zeros(count, dtype=a.dtype, device=a.device)
        total = torch.zeros_like(off)
        for r in range(N):
            for c in range(N):
                x2 = a[:, r, c] * a[:, r, c]
                total = total + x2
                if r != c:
                    off = off + x2
        active = active & (off > TOL2 * total)
        if not bool(active.any()):
            break
        sweeps = sweeps + active.to(torch.int32)
        for p in range(N - 1):
            for q in range(p + 1, N):
                apq = a[:, p, q]
                go = active & (apq != 0.0)
                app, aqq = a[:, p, p], a[:, q, q]
                safe = torch.where(go, apq, torch.ones_like(apq))
                theta = (aqq - app) / (2.0 * safe)
                t = 1.0 / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
                t = torch.where(theta < 0.0, -t, t)
                c = 1.0 / torch.sqrt(t * t + 1.0)
                s = t * c
                akp, akq = a[:, :, p], a[:, :, q]
                vkp, vkq = v[:, :, p], v[:, :, q]
                nkp = c[:, None] * akp - s[:, None] * akq
                nkq = s[:, None] * akp + c[:, None] * akq
                other = (rows != p) & (rows != q)
                new_p = torch.where(other, nkp, torch.zeros_like(nkp))
                new_q = torch.where(other, nkq, torch.zeros_like(nkq))
                new_p[:, p] = app - t * apq
                new_q[:, q] = aqq + t * apq
                g = go[:, None]
                col_p = torch.where(g, new_p, akp)
                col_q = torch.where(g, new_q, akq)
                a[:, :, p] = col_p
                a[:, p, :] = col_p
                a[:, :, q] = col_q
                a[:, q, :] = col_q
                v_p = torch.where(g, c[:, None] * vkp - s[:, None] * vkq, vkp)
                v_q = torch.where(g, s[:, None] * vkp + c[:, None] * vkq, vkq)
                v[:, :, p] = v_p
                v[:, :, q] = v_q
    diag = a.diagonal(dim1=-2, dim2=-1)
    best = torch.zeros(count, dtype=torch.int64, device=a.device)
    least = diag[:, 0]
    for i in range(1, N):
        lower_here = diag[:, i] < least
        least = torch.where(lower_here, diag[:, i], least)
        best = torch.where(lower_here, torch.full_like(best, i), best)
    vec = torch.gather(v, 2, best[:, None, None].expand(-1, N, 1))[..., 0]
    vec = vec.reshape(batch + (N,))
    return (vec, sweeps.reshape(batch)) if return_sweeps else vec
