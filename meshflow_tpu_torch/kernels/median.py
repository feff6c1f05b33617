"""Median filters of the vertex-velocity fields.

1. The per-vertex median over a masked set of feature residuals, with
   ``statistics.median`` semantics (mean of the two middle values for an
   even count, 0 for an empty set).
2. A 3x3 spatial median with replicated borders (cv2.medianBlur on
   float32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the masked entries of the last axis: (..., N) -> (...)."""
    filled = torch.where(mask, values, torch.full_like(values, float("inf")))
    s = torch.sort(filled, dim=-1).values
    count = mask.sum(dim=-1)
    lo = torch.clamp((count - 1) // 2, min=0)
    hi = torch.clamp(count // 2, min=0)
    lo_v = torch.gather(s, -1, lo[..., None])[..., 0]
    hi_v = torch.gather(s, -1, hi[..., None])[..., 0]
    med = 0.5 * (lo_v + hi_v)
    return torch.where(count > 0, med, torch.zeros_like(med))


def median3x3(field: torch.Tensor) -> torch.Tensor:
    """3x3 median with BORDER_REPLICATE on the last two axes."""
    shape = field.shape
    flat = field.reshape((-1, 1) + shape[-2:])
    padded = F.pad(flat, (1, 1, 1, 1), mode="replicate").reshape(
        shape[:-2] + (shape[-2] + 2, shape[-1] + 2)
    )
    h, w = shape[-2], shape[-1]
    neighbors = [
        padded[..., dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)
    ]
    return torch.sort(torch.stack(neighbors, dim=-1), dim=-1).values[..., 4]
