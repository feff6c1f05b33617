"""The render's per-pixel sampling on the card: the bilinear warp through
kernel B's backward maps, and the crop-stretch back to full size.

``warp`` and ``crop_resize`` launch ``csrc/render.cu`` for CUDA tensors, one
launch over every frame given, and take the plain versions
(``warp_frame_plain`` and ``crop_resize_frame_plain`` in
``render/stabilize.py``, a frame at a time) for CPU tensors; neither falls
back to the other.  No TPU kernel is replaced: the JAX package renders with
XLA-fused array code.  The kernels give the plain versions' bits
(``tests/test_torch_render_exact.py``).  On a CUDA tensor a wrapper runs no
PyTorch op besides allocating its output and copies nothing from the host:
the border colour goes to the kernel as arguments and the crop is read from
device memory, so a CUDA graph can capture either launch.
``warp.launches`` and ``crop_resize.launches`` count calls of the entry
points.
"""

from __future__ import annotations

import math

import torch

from meshflow_tpu_torch.kernels import _launch
from meshflow_tpu_torch.render.stabilize import (
    BackwardMap,
    crop_resize_frame_plain,
    warp_frame_plain,
)

__all__ = ["crop_resize", "crop_resize_plain", "warp", "warp_plain"]

MAX_FRAMES = 65535  # a launch's grid.z


def warp_plain(frames: torch.Tensor, bmap: BackwardMap, border) -> torch.Tensor:
    """The plain warp of one frame (H, W, C) or of a block (F, H, W, C), one
    frame at a time."""
    if frames.dim() == 3:
        return warp_frame_plain(frames, bmap, border)
    return torch.stack([
        warp_frame_plain(frame, BackwardMap(*(m[i] for m in bmap)), border)
        for i, frame in enumerate(frames)
    ])


def crop_resize_plain(frames: torch.Tensor, crop: torch.Tensor, frame_height: int,
                      frame_width: int) -> torch.Tensor:
    """The plain crop-stretch of one frame (H, W, C) or of a block (F, H, W,
    C), one frame at a time."""
    if frames.dim() == 3:
        return crop_resize_frame_plain(frames, crop, frame_height, frame_width)
    return torch.stack([crop_resize_frame_plain(f, crop, frame_height, frame_width)
                        for f in frames])


def _frames_of(name: str, frames: torch.Tensor, height: int, width: int) -> int:
    """The frame count of (..., height, width, C) uint8 frames, C 1 or 3."""
    if (
        frames.dim() < 3 or tuple(frames.shape[-3:-1]) != (height, width)
        or frames.shape[-1] not in (1, 3)
    ):
        raise ValueError(f"{name}: expected frames (..., {height}, {width}, 1 or 3), "
                         f"got {tuple(frames.shape)}")
    f = math.prod(frames.shape[:-3])
    if f > MAX_FRAMES:
        raise ValueError(f"{name}: at most {MAX_FRAMES} frames a launch, got {f}")
    return f


def warp(frames: torch.Tensor, bmap: BackwardMap, border) -> torch.Tensor:
    """Frames (..., H, W, C) uint8 warped by their backward maps (..., H, W)
    with the border colour `border` (C numbers): (..., H, W, C) uint8."""
    if _launch.on_cpu(frames, *bmap):
        return warp_plain(frames, bmap, border)
    h, w = bmap.map_x.shape[-2:]
    f = _frames_of("render warp", frames, h, w)
    c = frames.shape[-1]
    lead = frames.shape[:-1]
    device = _launch.require(
        "render warp", (frames, torch.uint8, frames.shape), (bmap.map_x, torch.float32, lead),
        (bmap.map_y, torch.float32, lead), (bmap.covered, torch.bool, lead), align=1,
    )
    colour = [float(v) for v in border]
    if len(colour) != c:
        raise ValueError(f"render warp: a border colour of {c} values, got {border}")
    out = torch.empty_like(frames)
    _launch.launch("meshflow_render_warp", device, frames, *bmap, out, f, h, w, c,
                   *(colour + [0.0] * (3 - c)))
    _launch.count(warp)
    return out


def crop_resize(frames: torch.Tensor, crop: torch.Tensor, frame_height: int,
                frame_width: int) -> torch.Tensor:
    """Frames (..., H, W, C) uint8 cropped to `crop` [left, top, right,
    bottom] (inclusive; (4,) int32 or int64) and stretched back to (H, W)."""
    if _launch.on_cpu(frames, crop):
        return crop_resize_plain(frames, crop, frame_height, frame_width)
    f = _frames_of("render crop", frames, frame_height, frame_width)
    if crop.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"render crop: the crop must be int32 or int64, got {crop.dtype}")
    device = _launch.require("render crop", (frames, torch.uint8, frames.shape),
                             (crop, crop.dtype, (4,)), align=1)
    out = torch.empty_like(frames)
    _launch.launch("meshflow_render_crop", device, frames, crop, crop.dtype == torch.int64, out,
                   f, frame_height, frame_width, frames.shape[-1])
    _launch.count(crop_resize)
    return out


warp.launches = 0
crop_resize.launches = 0
