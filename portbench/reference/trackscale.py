# Frozen copy of meshflow_tpu_torch/motion/trackscale.py, plain PyTorch route only.
"""Track geometry: motion estimation on box-downscaled frames (the port of
``meshflow_tpu/motion/trackscale.py``).

Above the track pixel budget (``MeshFlowConfig.resolve_track_downscale``:
d=2 at 720p, d=3 at 1080p) every tracking stage runs on d x d
box-downscaled frames, and the results are converted back at the solver
boundary:

* vertex velocities scale by (sx, sy) = (w/tw, h/th), exact because the
  banded Jacobi solve is linear in the displacements;
* per-pair homographies conjugate as H_full = S H_track S^-1 with
  S = diag(sx, sy, 1), which leaves the adaptive-weight features and the
  metric formulas invariant;
* the metric pass compares the d-downscaled original with the
  d-downscaled output.

The downscale is an exact integer box mean with cv2.resize(INTER_AREA)
rounding: the device version reproduces cv2's tie rule per factor
(half-up when d*d is odd, where ties cannot occur; half-up at d=2;
half-even at even d >= 4), so host- and device-derived track planes agree
bit for bit.  Frames are cropped to (th*d, tw*d) first.  Under
track_planes="gray" the trackers consume the exact cv2 gray of the
downscaled frames, one plane (C=1).
"""

from __future__ import annotations

import torch

from .config import MeshFlowConfig
from .color import bgr_to_gray

# Texels (frames x height x width x channels) box-downscaled together:
# bounds a block's int32 copy to ~400 MB at any frame size (143 frames of
# 640x360, 16 of 1080p, 4 of 4K).  The sums stay int32 (at most
# 255 * d * d): a default integer sum would promote them to int64, which
# took 19.2 GB for a 64-frame 4K block.
_BLOCK_TEXELS = 16 * 1920 * 1080 * 3


def scale_factors(
    frame_height: int, frame_width: int, config: MeshFlowConfig
) -> tuple[float, float]:
    """(sx, sy): track-geometry displacements -> full-resolution pixels."""
    th, tw = config.track_shape(frame_height, frame_width)
    return frame_width / tw, frame_height / th


def _box_block(frames: torch.Tensor, d: int) -> torch.Tensor:
    f, h, w, c = frames.shape
    th, tw = h // d, w // d
    cropped = frames[:, : th * d, : tw * d]
    s = cropped.reshape(f, th, d, tw, d, c).to(torch.int32).sum(dim=(2, 4), dtype=torch.int32)
    dd = d * d
    base, rem = s // dd, s % dd
    if dd % 2 == 1:
        rounded = base + (2 * rem > dd).to(torch.int32)
    elif d == 2:
        rounded = base + (2 * rem >= dd).to(torch.int32)
    else:
        up = torch.where(2 * rem == dd, base % 2, (2 * rem > dd).to(torch.int32))
        rounded = base + up
    return rounded.to(torch.uint8)


def box_downscale_dev(frames: torch.Tensor, d: int) -> torch.Tensor:
    """The d x d box downscale on the device (cv2 INTER_AREA, uint8 in and
    out, integer arithmetic throughout), on the frames' device."""
    if d == 1:
        return frames
    block = max(1, _BLOCK_TEXELS // frames[0].numel())
    return torch.cat(
        [_box_block(frames[i : i + block], d) for i in range(0, frames.shape[0], block)]
    )


def planes_dev(frames_bgr: torch.Tensor, config: MeshFlowConfig) -> torch.Tensor:
    """(..., 3) uint8 BGR -> the planes the trackers consume at the frames'
    own size: the frames themselves, or under track_planes="gray" their
    exact cv2 gray as (..., 1)."""
    if config.track_planes == "gray":
        return bgr_to_gray(frames_bgr)[..., None]
    return frames_bgr


def to_track_planes_dev(frames_bgr: torch.Tensor, config: MeshFlowConfig) -> torch.Tensor:
    """(F, H, W, 3) uint8 BGR -> downscaled (F, th, tw, C) tracker planes:
    the d x d box downscale first, then the gray (C=1) under
    track_planes="gray", as cv2's gray of the host-downscaled frames."""
    d = config.resolve_track_downscale(frames_bgr.shape[1], frames_bgr.shape[2])
    return planes_dev(box_downscale_dev(frames_bgr, d), config)


def metric_rerender(config: MeshFlowConfig, frame_height: int, frame_width: int) -> bool:
    """Whether the metric pass re-renders the track planes through the
    output's maps and crop: gray planes at full size (d=1) with metrics
    on, the JAX package's default metric source there.  Otherwise it
    tracks the track planes of the cropped output (d > 1: its box
    downscale, then gray)."""
    return (
        config.compute_metrics
        and config.track_planes == "gray"
        and config.resolve_track_downscale(frame_height, frame_width) == 1
    )


def scale_velocities(velocities: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """Per-pair vertex velocities, track geometry -> full-res pixels."""
    return velocities * torch.tensor([sx, sy], dtype=velocities.dtype, device=velocities.device)


def conjugate_homographies(homographies: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """H_full = S H_track S^-1, S = diag(sx, sy, 1), batched over frames;
    H22 = 1 is preserved."""
    s = torch.tensor([sx, sy, 1.0], dtype=homographies.dtype, device=homographies.device)
    return homographies * (s[:, None] / s[None, :])
