"""Seeded synthetic clips: integer-shift crops of one blurred-noise canvas.

A copy of the generator the port's chip checks use (a right pan over the
clip plus +-jitter px of shake), with the seed as an argument, so that the
yardstick does not move when those checks change.
"""

from __future__ import annotations

import numpy as np


def synthetic_clip(seed, num_frames: int, h: int, w: int, pan: float, jitter: int = 3,
                   margin: int = 40) -> np.ndarray:
    """(num_frames, h, w, 3) uint8 BGR: frame t is the window at
    x = margin + round(pan * t / (num_frames - 1)) + jx, y = margin + jy of
    a canvas of 4x4-pixel noise blocks blurred twice by [1, 2, 1] / 4 on
    each axis, (jx, jy) drawn from [-jitter, jitter].  `seed` is an int or
    a sequence of ints (numpy's SeedSequence)."""
    rng = np.random.default_rng(seed)
    span = int(np.ceil(pan))
    small = rng.integers(0, 256, ((h + 2 * margin) // 4 + 1, (w + span + 2 * margin) // 4 + 1, 3))
    canvas = np.repeat(np.repeat(small, 4, 0), 4, 1).astype(np.float32)
    for _ in range(2):
        for ax in (0, 1):
            canvas = 0.25 * np.roll(canvas, 1, ax) + 0.5 * canvas + 0.25 * np.roll(canvas, -1, ax)
    canvas = np.round(canvas).astype(np.uint8)
    frames = np.empty((num_frames, h, w, 3), np.uint8)
    shake = rng.integers(-jitter, jitter + 1, (num_frames, 2))
    for t in range(num_frames):
        jx, jy = shake[t]
        x0 = margin + int(round(pan * t / max(num_frames - 1, 1))) + jx
        y0 = margin + jy
        frames[t] = canvas[y0 : y0 + h, x0 : x0 + w]
    return frames
