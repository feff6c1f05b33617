"""Public API: the reference's MeshFlowStabilizer on PyTorch.

Constructor keywords, constants, the return tuple and the ValueError /
IOError behaviour follow ``meshflow_tpu/api.py:54-273``.  ``stabilize``
routes by MESHFLOW_STREAM as the JAX package does: ``auto`` (the default)
and ``1`` take the two-pass streaming pipeline (``streaming.py``: O(chunk)
pixels on the device, checkpoint/resume), ``0`` the in-memory route, which
decodes the whole clip, runs ``_stabilize_frames`` on the device and
encodes the result.  The JAX package streams only where its native host
renderer is built; the port's stream renders on the device and needs no
host renderer, so it has no precondition but ``visualize`` off.  Decode
and encode go through the native libav library when it loads, else cv2
(``io.video``).  ``_stabilize_frames`` is the in-memory, device-render
route:

0. above the track pixel budget, d x d box-downscaled track planes
   (motion.trackscale; d=3 at 1080p); under track_planes="gray" (or
   MESHFLOW_TRACK_PLANES=gray) their exact cv2 gray, one plane
1. gray, FAST per subframe, at track geometry (motion.pipeline)
2. LK over all adjacent pairs (kernel A, or C under MESHFLOW_LK_FETCH=band),
   RANSAC, propagation, cumsum; velocities and homographies scaled back to
   full resolution
3. adaptive weights + banded Jacobi                  (solver)
4. backward map (kernel B), warp, crop edges; crop + stretch (render),
   at full resolution, on the BGR frames
5. cropping ratio + distortion (the LK kernel again, at track geometry:
   on box-downscaled cropped frames, or, for gray planes at d=1, on the
   gray planes warped through step 4's maps and crop), stability
   (metrics)

Stages are timed by ``utils.profiling.StageTimer`` (``last_timer``), and
each call is a request of the span recorder (``utils/profiling.py``):
``stabilize`` its root, ``clip`` the in-memory stages' parent.
``visualize=True`` takes the in-memory route and shows each input frame
above its output (``_display_loop``) once the output is written.  The
JAX package's host renderer is left behind: the port renders on the
device, and its gray route keeps the BGR frames there for the output.
Online mode is ``online.py``; the frame-sharded and multi-clip paths are
``parallel/``.
"""

from __future__ import annotations

import dataclasses
import os
import weakref

import torch

from meshflow_tpu_torch import config as cfg
from meshflow_tpu_torch import streaming
from meshflow_tpu_torch.config import MeshFlowConfig, validate_adaptive_weights_definition
from meshflow_tpu_torch.io import video as video_io
from meshflow_tpu_torch.kernels.fast import Keypoints
from meshflow_tpu_torch.metrics.quality import cropping_and_distortion, stability_score
from meshflow_tpu_torch.motion import trackscale
from meshflow_tpu_torch.motion.pipeline import estimate_motion_chunked, prepare_frames
from meshflow_tpu_torch.render.stabilize import crop_frames, intersect_crops, render_block
from meshflow_tpu_torch.solver.jacobi import jacobi_smooth
from meshflow_tpu_torch.solver.weights import adaptive_weights
from meshflow_tpu_torch.utils import graphs, grid, prng, profiling
from meshflow_tpu_torch.utils.profiling import StageTimer


def default_device() -> str:
    """The port runs on the card unless the caller asks for the CPU
    (``device="cpu"``); without a card the default fails as torch does."""
    return "cuda"


class MeshFlowStabilizer:
    """Drop-in replacement for the reference class, plus ``device``.

    On the card the motion and metric batches (16 pairs each, padded) run
    as CUDA graphs of the stabilizer's own runner (``utils/graphs.py``):
    one graph a batch kind and clip geometry, captured at its second batch
    and replayed after, also by later calls.  The graphs and their shared
    memory pool (the batches' working set: 2.06 GiB on the 16x16 mesh,
    20.9 GiB on the 64x64 mesh, measured on an H100 80GB HBM3 at 700 W)
    are freed by ``close()`` or when the stabilizer is collected; each
    geometry it has run adds its graphs to the pool until then.
    ``_graphs=False`` runs the card eagerly (for comparisons)."""

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
        _graphs: bool = True,
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
        self.config = config
        # Checkpoint/resume of the streaming route's pass 1 (checkpoint.py).
        self.checkpoint_dir = checkpoint_dir
        self.device = torch.device(device if device is not None else default_device())
        self._key = prng.PRNGKey(seed, device=self.device)
        self.last_timer: StageTimer | None = None
        # The motion and metric batches' runner and its graphs, until
        # close() or collection.
        self._runner = graphs.GraphRunner(enabled=_graphs)
        weakref.finalize(self, self._runner.clear)

    def close(self) -> None:
        """Free the batches' CUDA graphs and their memory pool (a later
        call captures them again)."""
        self._runner.clear()

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
        self.last_timer = timer
        mode = os.environ.get("MESHFLOW_STREAM", "auto")
        if mode == "1" and self.config.visualize:
            raise RuntimeError(
                "MESHFLOW_STREAM=1 is incompatible with visualize=True "
                "(the streaming pipeline does not retain frames); "
                "unset one of them."
            )
        shown = None
        with profiling.recording(timer.enabled), profiling.span(
            "stabilize", device=self.device
        ):
            if mode in ("auto", "1") and not self.config.visualize:
                result = streaming.stabilize_streamed(
                    input_path, output_path, adaptive_weights_definition, self.config,
                    self._key, timer, self.device, chunk=self.CHUNK,
                    checkpoint_dir=self.checkpoint_dir, runner=self._runner,
                )
            else:
                result, shown = self._stabilize_in_memory(
                    input_path, output_path, adaptive_weights_definition, timer)
        timer.report()
        if shown is not None:
            self._display_loop(*shown)
        return result

    def _stabilize_in_memory(self, input_path, output_path, adaptive_weights_definition,
                             timer):
        """The in-memory route of ``stabilize``: (scores, (input frames,
        output frames, fps) when visualize is on, else None)."""
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
        scores = float(cropping_ratio), float(distortion), float(stability)
        return scores, (frames_np, cropped_np, info.fps) if self.config.visualize else None

    # ------------------------------------------------------------------
    def _stabilize_frames(
        self, frames: torch.Tensor, adaptive_weights_definition: int, timer=None
    ):
        """(F, H, W, 3) uint8 -> (cropped (F, H, W, 3) uint8, cropping_ratio,
        distortion_score, stability_score), all tensors on self.device.
        timer: a StageTimer (default: one that MESHFLOW_TIMINGS enables),
        kept as ``last_timer``.  The call is the span ``clip``, the root of
        its request unless a ``stabilize`` call holds it."""
        validate_adaptive_weights_definition(adaptive_weights_definition)
        timer = timer or StageTimer(device=self.device)
        self.last_timer = timer
        with profiling.recording(timer.enabled), profiling.span(
            "clip", device=self.device
        ):
            return self._stages(frames, adaptive_weights_definition, timer)

    def _stages(self, frames, adaptive_weights_definition: int, timer):
        """The body of ``_stabilize_frames``."""
        config = self.config
        frames = torch.as_tensor(frames).to(self.device)
        if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
            raise ValueError("frames must be (F, H, W, 3) uint8 BGR")
        num_frames, h, w = frames.shape[:3]
        chunk = min(self.CHUNK, num_frames)
        unstab_grid = grid.vertex_grid(config, h, w, device=self.device)

        # Track geometry: detection, motion and the metric pass run at
        # (th, tw) on box-downscaled planes (gray planes under
        # track_planes="gray"); solver and render at (h, w) on the BGR
        # frames.
        d_track = config.resolve_track_downscale(h, w)
        th, tw = config.track_shape(h, w)
        frames_track = trackscale.to_track_planes_dev(frames, config)
        sx, sy = trackscale.scale_factors(h, w, config)
        # Gray planes at full size: the metric pass re-renders them through
        # the BGR render's maps and crop (the JAX package's default metric
        # source); otherwise it takes the track planes of the cropped output.
        rerender = trackscale.metric_rerender(config, h, w)

        with timer.stage("detect"):
            keypoints, _ = prepare_frames(frames_track, config)
        with timer.stage("motion"):
            motion = estimate_motion_chunked(
                keypoints, frames_track, prng.fold_in(self._key, 1), config, th, tw,
                chunk_pairs=max(chunk - 1, 1), runner=self._runner,
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
            stabilized, stabilized_track, crops = [], [], []
            for start in range(0, num_frames, chunk):
                sl = slice(start, start + chunk)
                s, s_track, c = render_block(
                    frames[sl], frames_track[sl] if rerender else None,
                    motion.displacements[sl], stab_disp[sl], unstab_grid, config, h, w)
                stabilized.append(s)
                stabilized_track.append(s_track)
                crops.append(c)
            crop = intersect_crops(crops)
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
                if rerender:
                    cropped_c = crop_frames(stabilized_track[start // chunk], crop, h, w)
                else:
                    cropped_c = trackscale.to_track_planes_dev(cropped[sl], config)
                r, d = cropping_and_distortion(
                    Keypoints(*(a[sl] for a in keypoints)),
                    frames_track[sl],
                    cropped_c,
                    metric_key,
                    start,
                    config,
                    th,
                    tw,
                    self._runner,
                )
                ratios.append(r)
                distortions.append(d)
            cropping_ratio = torch.cat(ratios).mean()
            distortion_score = torch.cat(distortions).amin()
        return cropped, cropping_ratio, distortion_score, stability

    # ------------------------------------------------------------------
    def _display_loop(self, unstabilized, cropped, fps):
        """The reference's visualize loop: each unstabilized frame above its
        cropped output in one window, the clip looping until Q."""
        import cv2
        import numpy as np

        ms_per_frame = int(1000 / fps) if fps > 0 else 33
        while True:
            for i in range(len(unstabilized)):
                cv2.imshow(
                    "unstabilized and stabilized video",
                    np.vstack((unstabilized[i], cropped[i])),
                )
                if cv2.waitKey(ms_per_frame) & 0xFF == ord("q"):
                    return
