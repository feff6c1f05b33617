"""Public API: the reference's MeshFlowStabilizer on PyTorch.

Constructor keywords, constants, the return tuple and the ValueError /
IOError behaviour follow ``meshflow_tpu/api.py:54-273``.  ``stabilize``
decodes the clip, runs ``_stabilize_frames`` on the device and encodes
the result.  ``_stabilize_frames`` is the in-memory, device-render route:

0. above the track pixel budget, d x d box-downscaled track planes
   (motion.trackscale; d=3 at 1080p)
1. BGR -> gray, FAST per subframe, at track geometry (motion.pipeline)
2. LK over all adjacent pairs (kernel A, or C under MESHFLOW_LK_FETCH=band),
   RANSAC, propagation, cumsum; velocities and homographies scaled back to
   full resolution
3. adaptive weights + banded Jacobi                  (solver)
4. backward map (kernel B), warp, crop edges; crop + stretch (render),
   at full resolution
5. cropping ratio + distortion (the LK kernel again, on box-downscaled
   cropped frames at track geometry), stability (metrics)

Stages are timed by ``utils.profiling.StageTimer`` (``last_timer``).  The
streaming route, the host renderer, gray planes, checkpointing, the
sharded path and ``visualize`` are not part of this port yet and raise
where the JAX package would take them.  Online mode is ``online.py``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from meshflow_tpu_torch import config as cfg
from meshflow_tpu_torch.config import MeshFlowConfig, validate_adaptive_weights_definition
from meshflow_tpu_torch.io import video as video_io
from meshflow_tpu_torch.kernels.fast import Keypoints
from meshflow_tpu_torch.metrics.quality import cropping_and_distortion, stability_score
from meshflow_tpu_torch.motion import trackscale
from meshflow_tpu_torch.motion.pipeline import estimate_motion_chunked, prepare_frames
from meshflow_tpu_torch.render.stabilize import crop_frames, render_stabilized
from meshflow_tpu_torch.solver.jacobi import jacobi_smooth
from meshflow_tpu_torch.solver.weights import adaptive_weights
from meshflow_tpu_torch.utils import grid, prng
from meshflow_tpu_torch.utils.profiling import StageTimer


def default_device() -> str:
    """The port runs on the card unless the caller asks for the CPU
    (``device="cpu"``); without a card the default fails as torch does."""
    return "cuda"


class MeshFlowStabilizer:
    """Drop-in replacement for the reference class, plus ``device``."""

    ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL = cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL
    ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED = cfg.ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH = cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW = cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH_VALUE = (
        cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH_VALUE
    )
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW_VALUE = (
        cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW_VALUE
    )

    # Frames per render / metric block; motion blocks hold CHUNK - 1 pairs.
    CHUNK = 64

    def __init__(
        self,
        mesh_row_count=16,
        mesh_col_count=16,
        mesh_outlier_subframe_row_count=4,
        mesh_outlier_subframe_col_count=4,
        feature_ellipse_row_count=10,
        feature_ellipse_col_count=10,
        homography_min_number_corresponding_features=4,
        temporal_smoothing_radius=10,
        optimization_num_iterations=100,
        color_outside_image_area_bgr=(0, 0, 255),
        visualize=False,
        config: MeshFlowConfig | None = None,
        seed: int = 0,
        checkpoint_dir: str | None = None,
        track_planes: str | None = None,
        compute_metrics: bool | None = None,
        device: str | torch.device | None = None,
    ):
        if config is None:
            config = MeshFlowConfig(
                mesh_row_count=mesh_row_count,
                mesh_col_count=mesh_col_count,
                mesh_outlier_subframe_row_count=mesh_outlier_subframe_row_count,
                mesh_outlier_subframe_col_count=mesh_outlier_subframe_col_count,
                feature_ellipse_row_count=feature_ellipse_row_count,
                feature_ellipse_col_count=feature_ellipse_col_count,
                homography_min_number_corresponding_features=(
                    homography_min_number_corresponding_features
                ),
                temporal_smoothing_radius=temporal_smoothing_radius,
                optimization_num_iterations=optimization_num_iterations,
                color_outside_image_area_bgr=tuple(color_outside_image_area_bgr),
                visualize=visualize,
            )
        # Tracking planes and checkpoints, as the JAX package reads them:
        # constructor argument > MESHFLOW_TRACK_PLANES / MESHFLOW_CHECKPOINT_DIR
        # (an empty value is ignored) > the config.
        if track_planes is None:
            track_planes = os.environ.get("MESHFLOW_TRACK_PLANES")
        if track_planes and track_planes != config.track_planes:
            config = dataclasses.replace(config, track_planes=track_planes)
        if checkpoint_dir is None:
            checkpoint_dir = os.environ.get("MESHFLOW_CHECKPOINT_DIR") or None
        # Serving mode: constructor argument > MESHFLOW_COMPUTE_METRICS
        # (0, false, no or off disable it, in any case) > the config.
        if compute_metrics is None:
            env = os.environ.get("MESHFLOW_COMPUTE_METRICS", "").strip().lower()
            if env:
                compute_metrics = env not in ("0", "false", "no", "off")
        if compute_metrics is not None and compute_metrics != config.compute_metrics:
            config = dataclasses.replace(config, compute_metrics=compute_metrics)
        if config.visualize:
            raise NotImplementedError("visualize=True is not ported yet")
        if config.track_planes != "bgr":
            raise NotImplementedError("track_planes='gray' is not ported yet")
        if checkpoint_dir is not None:
            raise NotImplementedError("checkpoint_dir is not ported yet")
        self.config = config
        self.device = torch.device(device if device is not None else default_device())
        self._key = prng.PRNGKey(seed, device=self.device)
        self.last_timer: StageTimer | None = None

    # ------------------------------------------------------------------
    def stabilize(
        self,
        input_path: str,
        output_path: str,
        adaptive_weights_definition: int = cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL,
    ):
        """Stabilize input_path -> output_path; returns
        (cropping_ratio, distortion_score, stability_score)."""
        validate_adaptive_weights_definition(adaptive_weights_definition)
        timer = StageTimer(device=self.device)
        with timer.stage("decode"):
            frames_np, info = video_io.read_video(input_path)
        with timer.stage("host->device"):
            frames = torch.from_numpy(frames_np).to(self.device)
        cropped, cropping_ratio, distortion, stability = self._stabilize_frames(
            frames, adaptive_weights_definition, timer
        )
        with timer.stage("device->host"):
            cropped_np = cropped.cpu().numpy()
        with timer.stage("encode"):
            video_io.write_video(output_path, cropped_np, info.fps, info.fourcc)
        timer.report()
        return float(cropping_ratio), float(distortion), float(stability)

    # ------------------------------------------------------------------
    def _stabilize_frames(
        self, frames: torch.Tensor, adaptive_weights_definition: int, timer=None
    ):
        """(F, H, W, 3) uint8 -> (cropped (F, H, W, 3) uint8, cropping_ratio,
        distortion_score, stability_score), all tensors on self.device.
        timer: a StageTimer (default: one that MESHFLOW_TIMINGS enables),
        kept as ``last_timer``."""
        validate_adaptive_weights_definition(adaptive_weights_definition)
        config = self.config
        timer = timer or StageTimer(device=self.device)
        self.last_timer = timer
        frames = torch.as_tensor(frames).to(self.device)
        if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
            raise ValueError("frames must be (F, H, W, 3) uint8 BGR")
        num_frames, h, w = frames.shape[:3]
        chunk = min(self.CHUNK, num_frames)
        unstab_grid = grid.vertex_grid(config, h, w, device=self.device)

        # Track geometry: detection, motion and the metric pass run at
        # (th, tw) on box-downscaled planes; solver and render at (h, w).
        d_track = config.resolve_track_downscale(h, w)
        th, tw = config.track_shape(h, w)
        frames_track = trackscale.to_track_planes_dev(frames, config) if d_track > 1 else frames
        sx, sy = trackscale.scale_factors(h, w, config)

        with timer.stage("detect"):
            keypoints, _ = prepare_frames(frames_track, config)
        with timer.stage("motion"):
            motion = estimate_motion_chunked(
                keypoints, frames_track, prng.fold_in(self._key, 1), config, th, tw,
                chunk_pairs=max(chunk - 1, 1),
            )
            if d_track > 1:
                motion = motion._replace(
                    displacements=trackscale.scale_velocities(motion.displacements, sx, sy),
                    homographies=trackscale.conjugate_homographies(
                        motion.homographies, sx, sy
                    ),
                )
        with timer.stage("solver"):
            lambdas = adaptive_weights(motion.homographies, w, h, adaptive_weights_definition)
            stab_disp = jacobi_smooth(
                motion.displacements,
                lambdas,
                config.temporal_smoothing_radius,
                config.optimization_num_iterations,
            )

        # Warp in blocks; the video crop is the intersection of the
        # per-block crops.
        with timer.stage("warp+crop"):
            stabilized, crops = [], []
            for start in range(0, num_frames, chunk):
                sl = slice(start, start + chunk)
                stab_c, crop_c = render_stabilized(
                    frames[sl], motion.displacements[sl], stab_disp[sl], unstab_grid,
                    config, h, w,
                )
                stabilized.append(stab_c)
                crops.append(crop_c)
            crops = torch.stack(crops)
            crop = torch.stack(
                [crops[:, 0].amax(), crops[:, 1].amax(), crops[:, 2].amin(), crops[:, 3].amin()]
            )
            cropped = torch.cat([crop_frames(s, crop, h, w) for s in stabilized])
        # Exposed for inspection: the last run's motion state and crop.
        self.last_motion, self.last_crop = motion, crop
        del stabilized
        stability = stability_score(stab_disp)
        if not config.compute_metrics:
            nan = torch.tensor(float("nan"), device=self.device)
            return cropped, nan, nan, stability

        with timer.stage("metrics"):
            ratios, distortions = [], []
            metric_key = prng.fold_in(self._key, 2)
            for start in range(0, num_frames, chunk):
                sl = slice(start, start + chunk)
                cropped_c = cropped[sl]
                if d_track > 1:
                    cropped_c = trackscale.to_track_planes_dev(cropped_c, config)
                r, d = cropping_and_distortion(
                    Keypoints(*(a[sl] for a in keypoints)),
                    frames_track[sl],
                    cropped_c,
                    metric_key,
                    start,
                    config,
                    th,
                    tw,
                )
                ratios.append(r)
                distortions.append(d)
            cropping_ratio = torch.cat(ratios).mean()
            distortion_score = torch.cat(distortions).amin()
        return cropped, cropping_ratio, distortion_score, stability
