# Frozen copy of meshflow_tpu_torch/kernels/eig3.py, plain PyTorch route only.
"""Eigenvalue magnitudes of affine homographies, closed form.

With the bottom row taken as [0, 0, 1], the eigenvalues of a 3x3
homography are {1} and those of its top-left 2x2 block; a complex pair
has magnitude sqrt(|det|).  Used by the adaptive weights and the
distortion score.
"""

from __future__ import annotations

import torch


def affine_eigenvalue_magnitudes(h: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) |eigenvalues|, sorted ascending."""
    a, b = h[..., 0, 0], h[..., 0, 1]
    c, d = h[..., 1, 0], h[..., 1, 1]
    tr = a + d
    det = a * d - b * c
    disc = tr * tr - 4.0 * det
    sqrt_disc = torch.sqrt(torch.abs(disc))
    real = disc >= 0
    root_det = torch.sqrt(torch.abs(det))
    m1 = torch.where(real, torch.abs((tr + sqrt_disc) * 0.5), root_det)
    m2 = torch.where(real, torch.abs((tr - sqrt_disc) * 0.5), root_det)
    mags = torch.stack([torch.ones_like(m1), m1, m2], dim=-1)
    return torch.sort(mags, dim=-1).values


def affine_eigen_ratio(h: torch.Tensor) -> torch.Tensor:
    """Second-largest over largest eigenvalue magnitude."""
    mags = affine_eigenvalue_magnitudes(h)
    denom = torch.where(
        mags[..., 2] == 0, torch.full_like(mags[..., 2], 1e-10), mags[..., 2]
    )
    return mags[..., 1] / denom
