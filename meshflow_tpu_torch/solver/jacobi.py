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
