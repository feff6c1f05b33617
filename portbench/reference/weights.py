# Frozen copy of meshflow_tpu_torch/solver/weights.py, plain PyTorch route only.
"""Adaptive regularization weights lambda_t (the port of
``meshflow_tpu/solver/weights.py``).

ORIGINAL and FLIPPED: a linear model over the translational element
sqrt((H02/W)^2 + (H12/H)^2) and the affine eigenvalue ratio of each
pair's homography,
lambda_t = max(min(-1.93 * trans + 0.95, 5.83 * affine +/- 4.88), 0).
CONSTANT_HIGH and CONSTANT_LOW are flat 100 and 1.
"""

from __future__ import annotations

import torch

from . import config as cfg
from .eig3 import affine_eigen_ratio


def adaptive_weights(
    homographies: torch.Tensor,
    frame_width: int,
    frame_height: int,
    adaptive_weights_definition: int,
) -> torch.Tensor:
    """lambda_t per frame: (F, 3, 3) -> (F,) float32."""
    num_frames = homographies.shape[0]
    kw = dict(dtype=homographies.dtype, device=homographies.device)
    if adaptive_weights_definition == cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH:
        return torch.full(
            (num_frames,), float(cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH_VALUE), **kw
        )
    if adaptive_weights_definition == cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW:
        return torch.full(
            (num_frames,), float(cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW_VALUE), **kw
        )
    translational = torch.sqrt(
        (homographies[:, 0, 2] / frame_width) ** 2
        + (homographies[:, 1, 2] / frame_height) ** 2
    )
    affine = affine_eigen_ratio(homographies)
    candidate_1 = -1.93 * translational + 0.95
    if adaptive_weights_definition == cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL:
        candidate_2 = 5.83 * affine + 4.88
    else:
        candidate_2 = 5.83 * affine - 4.88
    return torch.clamp(torch.minimum(candidate_1, candidate_2), min=0.0)
