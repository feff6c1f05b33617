"""State carried across from the JAX package, as numpy arrays.

The system has no learned weights: what moves between the two packages
is the configuration, the PRNG key, the motion state and the online
state.  The caller converts JAX arrays with ``np.asarray``; this module
imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels.fast import Keypoints
from meshflow_tpu_torch.motion.pipeline import MotionEstimate
from meshflow_tpu_torch.utils import prng


def config_from_fields(fields: dict) -> MeshFlowConfig:
    """The port's config from ``dataclasses.asdict(jax_config)``; a field
    the port does not have raises TypeError."""
    kwargs = dict(fields)
    if "color_outside_image_area_bgr" in kwargs:
        kwargs["color_outside_image_area_bgr"] = tuple(
            kwargs["color_outside_image_area_bgr"]
        )
    return MeshFlowConfig(**kwargs)


def key_from_jax(key: np.ndarray, device="cpu") -> torch.Tensor:
    """A raw jax.random key (uint32[2]) as the port's key."""
    return prng.key_data(np.array(key, dtype=np.uint32)).to(device)


def keypoints_from_numpy(positions, scores, valid, device="cpu") -> Keypoints:
    return Keypoints(
        positions=torch.as_tensor(np.array(positions, np.float32), device=device),
        scores=torch.as_tensor(np.array(scores, np.int32), device=device),
        valid=torch.as_tensor(np.array(valid, bool), device=device),
    )


def motion_from_numpy(
    displacements, homographies, pair_ok, device="cpu"
) -> MotionEstimate:
    """Motion state (displacements (F, R+1, C+1, 2), homographies
    (F, 3, 3), pair_ok (F-1,)) as the port's MotionEstimate."""
    return MotionEstimate(
        displacements=torch.as_tensor(np.array(displacements, np.float32), device=device),
        homographies=torch.as_tensor(np.array(homographies, np.float32), device=device),
        pair_ok=torch.as_tensor(np.array(pair_ok, bool), device=device),
    )


def online_state_from_numpy(
    prev_frame,
    positions,
    scores,
    valid,
    unstab_window,
    stab_window,
    step,
    config: MeshFlowConfig,
    device="cpu",
):
    """A JAX ``OnlineState`` as the port's: the previous frame's keypoints
    ((S, K) positions, scores, valid), both (OMEGA+1, R+1, C+1, 2) windows
    and the step count (a device tensor, as the port keeps it) are
    carried across; the previous frame's tile
    planes are rebuilt from ``prev_frame`` ((H, W, 3) uint8 BGR; gray
    planes under track_planes="gray") by the port's ``online_prepare``
    (the JAX state's pyramid layout depends on its tracker backend)."""
    from meshflow_tpu_torch.motion.trackscale import planes_dev
    from meshflow_tpu_torch.online import OnlineState, online_prepare

    frame = torch.as_tensor(np.array(prev_frame, np.uint8), device=device)
    _, planes = online_prepare(planes_dev(frame, config), config, frame.shape[0],
                               frame.shape[1])
    return OnlineState(
        prev_planes=planes,
        prev_kps=keypoints_from_numpy(positions, scores, valid, device=device),
        unstab_window=torch.as_tensor(np.array(unstab_window, np.float32), device=device),
        stab_window=torch.as_tensor(np.array(stab_window, np.float32), device=device),
        step=torch.tensor(int(step), dtype=torch.int64, device=device),
    )
