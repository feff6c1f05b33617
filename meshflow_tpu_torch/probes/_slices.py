"""The start of a dynamic slice, as the probes' Pallas kernels take it.

Pallas in interpret mode (like ``jax.lax.dynamic_slice``) adds the axis
length to a negative start once, then clamps the start into
[0, dim - size], so a slice never leaves its array.  Every probe of this
package takes its starts through ``dyn_start``; its CUDA twin is
``probes::dyn_start`` in ``csrc/probes.cuh``.
"""

from __future__ import annotations

import torch


def dyn_start(start, dim: int, size: int):
    """Start of a `size`-long slice at `start` along an axis of `dim`: an
    int, or an int tensor taken element by element."""
    if isinstance(start, torch.Tensor):
        return torch.where(start < 0, start + dim, start).clamp(0, dim - size)
    start = start + dim if start < 0 else start
    return min(max(start, 0), dim - size)
