"""Online (streaming) minimum-latency stabilization: the port of
``meshflow_tpu/online.py``.

Each incoming frame is stabilized from the committed past only, at one
frame of algorithmic latency.  Per frame t:

1. track frame t-1's keypoints into frame t (the LK kernel that
   ``MESHFLOW_LK_FETCH`` names, one launch per pyramid level; the plain
   version on the CPU), match and propagate -> velocity -> unstabilized
   displacement c_t = c_{t-1} + v;
2. solve for p_t over a causal window of the last OMEGA committed
   stabilized displacements, the exact coordinate-descent step of the
   offline energy for the newest frame with the past frozen,
   p_t = (c_t + 2 lambda_t sum_r w_{t,r} p_r) / (1 + 2 lambda_t sum_r w_{t,r}),
   then clamp p_t - c_t to the reserved cropping margin;
3. warp frame t by (p_t - c_t) (backward map: kernel B on the card) and
   apply the fixed reserved-margin crop (both ``csrc/render.cu`` on the
   card).

Under track_planes="gray" steps 1 and 2 take the frame's exact cv2 gray
(one plane, full size) and step 3 warps the BGR frame.  The JAX package
prefers its native host renderer when one is built, and needs it for
gray planes; the port has none and always takes the device-warp branch,
the BGR frame on the device.

The JAX package jits ``online_step``, one program a frame.  On the card
the port runs it as one CUDA graph (``utils/graphs.GraphRunner``): the
second frame runs the step eagerly, the third captures it and every
later frame replays it.  The step count is a device tensor, and every tensor
made from host data (the vertex grid, the subframe offsets, the Gaussian
band, the margin limit, the crop) is made once, by ``online_constants``,
and passed in; the border colour reaches the warp kernel as its arguments.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import NamedTuple

import numpy as np
import torch

from meshflow_tpu_torch.api import default_device
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels.bmap_cuda import backward_map
from meshflow_tpu_torch.kernels.color import bgr_to_gray
from meshflow_tpu_torch.kernels.fast import Keypoints, detect_keypoints
from meshflow_tpu_torch.kernels.lk_fetch import fetch_route
from meshflow_tpu_torch.kernels.pyramid import pyramid_shapes
from meshflow_tpu_torch.motion.features import match_from_tracks
from meshflow_tpu_torch.motion.pipeline import (
    pack_tile_planes_u8,
    subframe_offsets_f32,
    track_planes,
)
from meshflow_tpu_torch.motion.propagate import vertex_velocities
from meshflow_tpu_torch.motion.trackscale import planes_dev
from meshflow_tpu_torch.render.stabilize import border_color, crop_resize_frame, warp_frame
from meshflow_tpu_torch.solver.jacobi import gaussian_band
from meshflow_tpu_torch.solver.weights import adaptive_weights
from meshflow_tpu_torch.utils import graphs, grid, prng
from meshflow_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class OnlineState:
    """Carried across steps: frame t-1's packed tile planes and keypoints
    (each step's preparation of frame t serves the next step's tracking),
    the windows of the last OMEGA+1 displacements, and the step count."""

    prev_planes: tuple  # per level (1, S, C, rows_l + 2*PAD, cols_l + 2*PAD) uint8
    prev_kps: Keypoints  # (S, K) keypoints of frame t-1
    unstab_window: torch.Tensor  # (OMEGA+1, R+1, C+1, 2) c_{t-OMEGA..t}
    stab_window: torch.Tensor  # (OMEGA+1, R+1, C+1, 2) p_{t-OMEGA..t}
    step: torch.Tensor  # () int64 on the state's device: frames processed so far


class OnlineConstants(NamedTuple):
    """The tensors a step reads that are made from host data, made once a
    stream (``online_constants``) so that a captured step copies nothing
    from the host."""

    vgrid: torch.Tensor  # (R+1, C+1, 2) float32 vertex grid
    offsets: torch.Tensor  # (1, S, 1, 2) float32 subframe corners
    band: torch.Tensor  # (2*OMEGA+1,) float32 Gaussian taps
    limit: torch.Tensor  # (2,) float32 margins: the clamp of p_t - c_t
    crop: torch.Tensor  # (4,) int32 the fixed crop


def online_constants(config: MeshFlowConfig, frame_height: int, frame_width: int,
                     crop_ratio: float, device) -> OnlineConstants:
    """The OnlineConstants of a stream of (H, W) frames on `device`."""
    margin_x, margin_y = _online_margins(frame_width, frame_height, crop_ratio)
    return OnlineConstants(
        vgrid=grid.vertex_grid(config, frame_height, frame_width, device=device),
        offsets=subframe_offsets_f32(config, frame_height, frame_width, device),
        band=gaussian_band(config.temporal_smoothing_radius, device),
        limit=torch.tensor([margin_x, margin_y], dtype=torch.float32, device=device),
        crop=torch.as_tensor(online_crop_rect(frame_width, frame_height, crop_ratio),
                             device=device),
    )


def online_prepare(frame: torch.Tensor, config: MeshFlowConfig, frame_height: int,
                   frame_width: int):
    """Per-frame preparation: (H, W, 3) uint8 BGR or (H, W, 1) uint8 gray
    planes -> (keypoints, planes)."""
    max_level = config.lk_max_level(frame_height, frame_width)
    gray = frame[..., 0] if frame.shape[-1] == 1 else bgr_to_gray(frame)
    kps = detect_keypoints(gray, config, frame_height, frame_width)
    planes, _ = pack_tile_planes_u8(frame[None], config, max_level)
    return kps, planes


def initial_state(frame: torch.Tensor, config: MeshFlowConfig) -> OnlineState:
    """The state after the first (H, W, 3) BGR frame: zero windows, step 0."""
    h, w = frame.shape[:2]
    zeros = torch.zeros(
        (config.temporal_smoothing_radius + 1, config.vertex_rows, config.vertex_cols, 2),
        dtype=torch.float32, device=frame.device,
    )
    kps, planes = online_prepare(planes_dev(frame, config), config, h, w)
    step = torch.zeros((), dtype=torch.int64, device=frame.device)
    return OnlineState(planes, kps, zeros, zeros.clone(), step)


def _online_margins(frame_width: int, frame_height: int, crop_ratio: float):
    return (
        int(round(frame_width * (1.0 - crop_ratio) / 2)),
        int(round(frame_height * (1.0 - crop_ratio) / 2)),
    )


def online_crop_rect(frame_width: int, frame_height: int, crop_ratio: float) -> np.ndarray:
    """The fixed reserved-margin crop [left, top, right, bottom]."""
    margin_x, margin_y = _online_margins(frame_width, frame_height, crop_ratio)
    return np.asarray(
        [margin_x, margin_y, frame_width - 1 - margin_x, frame_height - 1 - margin_y],
        np.int32,
    )


def online_motion_solve(
    state: OnlineState,
    frame: torch.Tensor,
    key: torch.Tensor,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
    adaptive_weights_definition: int = 0,
    crop_ratio: float = 0.8,
    consts: OnlineConstants | None = None,
):
    """Motion + causal solve for one frame: (state, frame t's track
    planes, (H, W, 3) BGR or (H, W, 1) gray) -> (new state, c_t, p_t).
    consts: the stream's ``online_constants`` (made here when None).

    The stabilizing shift p_t - c_t is clamped per vertex to the reserved
    cropping margin: a shift of +-margin moves content by exactly the
    strip the fixed crop discards, so the crop window stays covered.
    """
    device = frame.device
    omega = config.temporal_smoothing_radius
    if consts is None:
        consts = online_constants(config, frame_height, frame_width, crop_ratio, device)

    cur_kps, cur_planes = online_prepare(frame, config, frame_height, frame_width)
    kps = state.prev_kps
    max_level = config.lk_max_level(frame_height, frame_width)
    tile_h, tile_w = config.subframe_shape(frame_height, frame_width)
    dims = tuple(pyramid_shapes(tile_h, tile_w, max_level))
    late, tracked = track_planes(
        kps.positions[None], kps.valid[None], state.prev_planes, cur_planes, dims,
        config, frame_height, frame_width, shifted=False, offsets=consts.offsets,
    )
    match = match_from_tracks(
        kps.positions[None], late, tracked, prng.fold_in(key, state.step)[None], config
    )
    velocity = vertex_velocities(
        match.early, match.late, match.inlier, match.homography, consts.vgrid,
        config, frame_height, frame_width,
    )[0]

    c_t = state.unstab_window[-1] + velocity
    unstab_window = torch.cat([state.unstab_window[1:], c_t[None]])
    lam = adaptive_weights(
        match.homography, frame_width, frame_height, adaptive_weights_definition
    )[0]

    # Causal Gaussian weights over the last OMEGA committed frames: window
    # slot i of past = stab_window[1:] holds p_{t-omega+i}, distance
    # omega - i from the new frame, weight band[i]; slots before the
    # stream's start are masked out.
    band = consts.band
    have = torch.arange(omega, device=device) >= torch.clamp(omega - state.step - 1, min=0)
    wgt = torch.where(have, band[:omega], torch.zeros_like(band[:omega]))
    denom = 1.0 + 2.0 * lam * wgt.sum()
    weighted_past = (wgt[:, None, None, None] * state.stab_window[1:]).sum(0)
    p_t = (c_t + 2.0 * lam * weighted_past) / denom

    limit = consts.limit
    p_t = c_t + torch.clamp(p_t - c_t, -limit, limit)

    stab_window = torch.cat([state.stab_window[1:], p_t[None]])
    new_state = OnlineState(cur_planes, cur_kps, unstab_window, stab_window, state.step + 1)
    return new_state, c_t, p_t


def _step(prev_planes, prev_kps, unstab_window, stab_window, step, frame, key, consts,
          config, frame_height, frame_width, adaptive_weights_definition, crop_ratio,
          route):
    """online_step on flat tensors: the unit a CUDA graph captures (`route`,
    the LK fetch route, only keys the graph)."""
    state = OnlineState(prev_planes, prev_kps, unstab_window, stab_window, step)
    new_state, c_t, p_t = online_motion_solve(
        state, planes_dev(frame, config), key, config, frame_height, frame_width,
        adaptive_weights_definition, crop_ratio, consts,
    )
    bmap = backward_map(
        consts.vgrid + (p_t - c_t), consts.vgrid, config, frame_height, frame_width
    )
    stabilized = warp_frame(frame, bmap, border_color(config, frame.shape[-1]))
    out = crop_resize_frame(stabilized, consts.crop, frame_height, frame_width)
    return (new_state.prev_planes, new_state.prev_kps, new_state.unstab_window,
            new_state.stab_window, new_state.step, out)


def online_step(
    state: OnlineState,
    frame: torch.Tensor,
    key: torch.Tensor,
    config: MeshFlowConfig,
    frame_height: int,
    frame_width: int,
    adaptive_weights_definition: int = 0,
    crop_ratio: float = 0.8,
    consts: OnlineConstants | None = None,
    runner: graphs.GraphRunner | None = None,
):
    """One streaming step: (state, BGR frame t) -> (new state, stabilized
    frame (H, W, 3) uint8 on the frame's device).  consts: the stream's
    ``online_constants`` (made here when None); runner: the step runs
    through it (an OnlineMeshFlowStabilizer passes its own, one CUDA graph
    on the card; None runs it directly)."""
    if consts is None:
        consts = online_constants(config, frame_height, frame_width, crop_ratio, frame.device)
    tensors = (state.prev_planes, state.prev_kps, state.unstab_window, state.stab_window,
               state.step, frame, key, consts)
    *new_state, out = graphs.run(
        runner, _step, tensors, config, frame_height, frame_width, adaptive_weights_definition,
        crop_ratio, fetch_route(),
    )
    return OnlineState(*new_state), out


class OnlineMeshFlowStabilizer:
    """Streaming stabilizer: feed frames, get stabilized frames back with
    one frame of latency (the first call returns the frame unchanged).

    On the card the step runs as one CUDA graph of the stabilizer's own
    runner: the second frame runs it eagerly, the third captures it, later
    frames replay it.  The graph and its memory pool (the step's working
    set) are released by ``close()`` or when the stabilizer is collected.
    ``_graphs=False`` runs the card eagerly (for comparisons)."""

    def __init__(
        self,
        config: MeshFlowConfig | None = None,
        adaptive_weights_definition: int = 0,
        crop_ratio: float = 0.8,
        seed: int = 0,
        device: str | torch.device | None = None,
        _graphs: bool = True,
    ):
        self.config = config or MeshFlowConfig()
        self.adaptive_weights_definition = adaptive_weights_definition
        self.crop_ratio = crop_ratio
        self.device = torch.device(device if device is not None else default_device())
        self._key = prng.PRNGKey(seed, device=self.device)
        self._state: OnlineState | None = None
        self._shape = None
        self._consts: OnlineConstants | None = None
        # The step's graph and its memory pool live from the third frame
        # until close() or collection.
        self._runner = graphs.GraphRunner(enabled=_graphs)
        weakref.finalize(self, self._runner.clear)

    def close(self) -> None:
        """Release the step's CUDA graph and its memory pool (a later frame
        captures it again)."""
        self._runner.clear()

    def process(self, frame: np.ndarray) -> np.ndarray:
        """frame: (H, W, 3) uint8 BGR -> stabilized (H, W, 3) uint8 BGR.
        The call is a request of the span recorder: ``online.frame``, with
        ``online.upload``, ``online.step`` (the runner's spans inside) and
        ``online.download``."""
        with span("online.frame", device=self.device):
            h, w = frame.shape[:2]
            with span("online.upload"):
                device_frame = torch.as_tensor(np.ascontiguousarray(frame)).to(self.device)
            if self._state is None:
                self._state = initial_state(device_frame, self.config)
                self._shape = (h, w)
                self._consts = online_constants(self.config, h, w, self.crop_ratio, self.device)
                return frame
            if self._shape != (h, w):
                raise ValueError("frame size changed mid-stream")
            with span("online.step"):
                self._state, out = online_step(
                    self._state, device_frame, self._key, self.config, h, w,
                    self.adaptive_weights_definition, self.crop_ratio, self._consts,
                    self._runner,
                )
            with span("online.download"):
                return out.cpu().numpy()
