"""The least time the card could take for a kernel's work.

Published H100 SXM peaks (NVIDIA's data sheet, dense rates): float32
outside the tensor cores and HBM3 bandwidth.  A bound is the larger of a
launch's operations over the float32 rate and its bytes over the memory
rate; a roofline share is the bound over the measured device time.  The
operation counts are those the LK function needs (not what a kernel
happens to repeat), copied from the port's chip checks, so the yardstick
reads the same work whatever implements it.  The card's power limit is
printed beside every run (``power_limit``): the peaks assume 700 W.
"""

from __future__ import annotations

import subprocess

H100_F32_FLOPS = 67e12
H100_HBM_BYTES = 3.35e12

WIN = 21  # the LK window
# Setting up the frozen previous window: one Scharr pair (18) at each of
# the (WIN+1)^2 support points per channel, then per window texel an image
# bilinear (9), two gradient bilinears (18) and three products and sums
# (6).  One step per window texel: a bilinear (9), a difference (1) and two
# products and sums (4).
LK_SCHARR_OPS = 18
LK_SETUP_OPS = 33
LK_STEP_OPS = 14
# Bytes of a slot's inputs and outputs at one level: position and guess
# (2 x 8), valid and status in (2), corner and status out (9).
LK_SLOT_BYTES = 2 * 8 + 2 + 9


def bound_s(ops: float, nbytes: float) -> float:
    """Seconds: the larger of ops at the float32 peak and bytes at HBM's."""
    return max(ops / H100_F32_FLOPS, nbytes / H100_HBM_BYTES)


def lk_level_ops(channels: int, setups: int, steps: int) -> float:
    """Float operations of one LK level: `setups` slots set up, `steps`
    steps taken in all, at `channels` planes."""
    setup = channels * (LK_SCHARR_OPS * (WIN + 1) ** 2 + LK_SETUP_OPS * WIN * WIN)
    return setups * setup + steps * channels * WIN * WIN * LK_STEP_OPS


def lk_bound_s(levels) -> float:
    """Summed bound of LK level launches, each a dict with channels,
    setups, steps, plane_bytes (the planes read once) and slots."""
    return sum(
        bound_s(lk_level_ops(lv["channels"], lv["setups"], lv["steps"]),
                lv["plane_bytes"] + lv["slots"] * LK_SLOT_BYTES)
        for lv in levels
    )


def bmap_bound_s(frames: int, launches: int, vertices: int, height: int, width: int) -> float:
    """Bound of the backward maps of `frames` frames of (height, width) in
    `launches` launches on a mesh of `vertices` vertices, by bytes: each
    frame's stabilized vertices (float32 x 2) read and its maps (x and y
    float32, the coverage byte) written, the unstabilized grid read once a
    launch."""
    nbytes = frames * (vertices * 8 + 9 * height * width) + launches * vertices * 8
    return nbytes / H100_HBM_BYTES


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi: {err}"
