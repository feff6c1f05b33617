"""The multi-clip batch: ``parallel/batch.py`` ``stabilize_batch``.

Independent clips share nothing: each job is its clip stabilized alone,
with the same seed, and the results come back in job order.  These are
the semantics the batch keeps however its jobs are spread over workers
and cards: job k's result is clip k's solo result.
"""

from __future__ import annotations

from .offline import stabilize_clip


def stabilize_clips(clips, config, adaptive_weights_definition: int = 0, seed: int = 0):
    """Each (F, H, W, 3) uint8 clip of `clips` (tensors on a device) through
    ``offline.stabilize_clip``, in job order: a list of (cropped, crop,
    cropping ratio, distortion, stability)."""
    return [stabilize_clip(clip, config, seed, adaptive_weights_definition) for clip in clips]
