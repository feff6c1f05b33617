"""Banded Jacobi energy minimization over all vertex profiles at once (the
port of ``meshflow_tpu/solver/jacobi.py``).

The off-diagonal of the reference's system is a lambda_t-scaled Gaussian
Toeplitz band g(d) = exp(-((3/Omega) d)^2), |d| <= Omega, whose band mask
includes the main diagonal (the i = 0 term of the reference's mask loop),
while the diagonal D[t] = 1 + 2 lambda_t sum_r g(t - r) sums the full row
without the band mask.  Both quirks are kept: this is the iteration as
the reference writes it, x <- (b - A_offdiag x) / D, with
(A_offdiag x)[t] = -2 lambda_t sum_d g(d) x[t - d].  The state is one
(F, V, 2) tensor; memory is O(F).
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_band(omega: int, device="cpu") -> torch.Tensor:
    """The 2*omega+1 taps exp(-((3/omega) d)^2), d in [-omega, omega]."""
    d = np.arange(-omega, omega + 1, dtype=np.float64)
    band = np.exp(-(((3.0 / omega) * d) ** 2)).astype(np.float32)
    return torch.from_numpy(band).to(device)


def on_diagonal(lambdas: torch.Tensor, omega: int) -> torch.Tensor:
    """D[t] = 1 + 2 lambda_t * sum_{r=0}^{F-1} g(t - r), the row sum taken
    in float64 over the window where g does not underflow."""
    num_frames = lambdas.shape[0]
    t = np.arange(num_frames, dtype=np.float64)
    radius = min(num_frames - 1, int(np.ceil(omega * np.sqrt(745.0) / 3.0)))
    d = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(((3.0 / omega) * d) ** 2))
    r = t[:, None] - d[None, :]
    valid = (r >= 0) & (r <= num_frames - 1)
    row_sum = np.sum(np.where(valid, g[None, :], 0.0), axis=1).astype(np.float32)
    return 1.0 + 2.0 * lambdas * torch.from_numpy(row_sum).to(lambdas.device)


def _band_matvec(x: torch.Tensor, band: torch.Tensor, omega: int) -> torch.Tensor:
    """sum_d band[d] * x[t - d], zero outside [0, F)."""
    num_frames = x.shape[0]
    xp = torch.cat(
        [x.new_zeros((omega,) + x.shape[1:]), x, x.new_zeros((omega,) + x.shape[1:])]
    )
    out = torch.zeros_like(x)
    for j in range(2 * omega + 1):
        out = out + band[2 * omega - j] * xp[j : j + num_frames]
    return out


def jacobi_smooth(
    b: torch.Tensor, lambdas: torch.Tensor, omega: int, iterations: int
) -> torch.Tensor:
    """The reference's Jacobi iteration on every vertex profile at once.

    b: (F, ...) unstabilized displacements, also the initial x; lambdas:
    (F,).  Returns the stabilized displacements, same shape."""
    band = gaussian_band(omega, b.device)
    extra = (1,) * (b.dim() - 1)
    lam = lambdas.reshape((-1,) + extra)
    inv_d = (1.0 / on_diagonal(lambdas, omega)).reshape((-1,) + extra)
    x = b
    for _ in range(iterations):
        offdiag_x = -2.0 * lam * _band_matvec(x, band, omega)
        x = inv_d * (b - offdiag_x)
    return x


def _band_matvec_halo(
    x_local: torch.Tensor,
    left: torch.Tensor | None,
    right: torch.Tensor | None,
    band: torch.Tensor,
    omega: int,
) -> torch.Tensor:
    """_band_matvec of one shard of a frame-sharded state: `left` and
    `right` are the neighbours' omega adjacent frames, None at the ends of
    the sequence, where the unsharded stencil's zero padding stands.  The
    2*omega+1 taps are added in _band_matvec's order, so the result equals
    _band_matvec of the concatenated state bit for bit."""
    block = x_local.shape[0]
    pad = x_local.new_zeros((omega,) + x_local.shape[1:])
    xp = torch.cat([pad if left is None else left, x_local, pad if right is None else right])
    out = torch.zeros_like(x_local)
    for j in range(2 * omega + 1):
        out = out + band[2 * omega - j] * xp[j : j + block]
    return out


def jacobi_smooth_halo(
    b_local: torch.Tensor, lambdas: torch.Tensor, omega: int, iterations: int, comm
) -> torch.Tensor:
    """One rank's jacobi_smooth with the (F, V, 2) state sharded over the
    frame axis (the JAX package's ``jacobi_smooth_sharded``).

    b_local: this rank's (B, ...) block of the unstabilized displacements
    on its device; lambdas: the full (F,) adaptive weights; comm: the
    rank's collectives (``parallel.workers.Collectives``: rank, world,
    ``halo``).  Per sweep the rank sends its first omega frames left and
    its last omega right, and takes its neighbours' in one exchange,
    instead of the whole state; the first rank has no left neighbour and
    the last no right one, where the unsharded stencil's zero padding
    stands.  Needs B >= omega when there is more than
    one rank.  Returns the rank's stabilized block, equal bit for bit to
    its block of jacobi_smooth on the whole state."""
    rank, world = comm.rank, comm.world
    block = b_local.shape[0]
    if world > 1 and block < omega:
        raise ValueError(f"halo solve needs shards of >= omega={omega} frames, got {block}")
    sl = slice(rank * block, (rank + 1) * block)
    extra = (1,) * (b_local.dim() - 1)
    band = gaussian_band(omega, b_local.device)
    lam = lambdas[sl].reshape((-1,) + extra)
    inv_d = (1.0 / on_diagonal(lambdas, omega))[sl].reshape((-1,) + extra)
    x = b_local
    for _ in range(iterations):
        left, right = comm.halo(x[:omega], x[-omega:])
        offdiag_x = -2.0 * lam * _band_matvec_halo(x, left, right, band, omega)
        x = inv_d * (b_local - offdiag_x)
    return x
