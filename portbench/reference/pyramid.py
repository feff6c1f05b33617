# Frozen copy of meshflow_tpu_torch/kernels/pyramid.py, plain PyTorch route only.
"""Gaussian pyramids matching cv2.buildOpticalFlowPyramid levels.

Repeated pyrDown: separable [1 4 6 4 1]/16 blur with BORDER_REFLECT_101,
even-index decimation, each 8-bit level rounded half-up.  Level l has
shape ((h+1)//2, (w+1)//2) of level l-1.  All sums are of 8-bit integers
times small integers, so float32 holds them exactly.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

_K = (1.0, 4.0, 6.0, 4.0, 1.0)


def reflect_pad(img: torch.Tensor, top: int, bottom: int, left: int, right: int):
    """REFLECT_101 padding of the last two dims (numpy's "reflect")."""
    shape = img.shape
    flat = img.reshape((-1, 1) + shape[-2:])
    out = F.pad(flat, (left, right, top, bottom), mode="reflect")
    return out.reshape(shape[:-2] + out.shape[-2:])


def _blur5_axis(img: torch.Tensor, axis: int) -> torch.Tensor:
    """5-tap [1 4 6 4 1] correlation along axis -2 or -1, REFLECT_101."""
    n = img.shape[axis]
    if axis == -2:
        p = reflect_pad(img, 2, 2, 0, 0)
    else:
        p = reflect_pad(img, 0, 0, 2, 2)
    out = None
    for i, k in enumerate(_K):
        term = k * p.narrow(axis, i, n)
        out = term if out is None else out + term
    return out


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """One cv2.pyrDown step on (..., H, W) float32 holding 8-bit values."""
    blurred = _blur5_axis(_blur5_axis(img, -2), -1) * (1.0 / 256.0)
    rounded = torch.floor(blurred + 0.5)
    return rounded[..., ::2, ::2]


def pyramid_shapes(h: int, w: int, max_level: int) -> List[Tuple[int, int]]:
    shapes = [(h, w)]
    for _ in range(max_level):
        h, w = (h + 1) // 2, (w + 1) // 2
        shapes.append((h, w))
    return shapes
