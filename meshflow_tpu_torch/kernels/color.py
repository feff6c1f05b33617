"""BGR -> gray with OpenCV's exact fixed-point rounding.

OpenCV 5 quantizes the BT.601 weights at shift 15 (R 9798, G 19235,
B 3735) and descales with round-half-up; FAST thresholds are sensitive to
off-by-one gray values, so the conversion is integer, not float.
"""

from __future__ import annotations

import torch

_R2Y = 9798
_G2Y = 19235
_B2Y = 3735
_SHIFT = 15


def bgr_to_gray(bgr: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 3) BGR -> uint8 (...), equal to cv2.COLOR_BGR2GRAY."""
    b = bgr[..., 0].to(torch.int32)
    g = bgr[..., 1].to(torch.int32)
    r = bgr[..., 2].to(torch.int32)
    y = (b * _B2Y + g * _G2Y + r * _R2Y + (1 << (_SHIFT - 1))) >> _SHIFT
    return y.to(torch.uint8)
