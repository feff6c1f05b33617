"""Public API: the reference's MeshFlowStabilizer on PyTorch, and the
clip pipeline.

Constructor keywords, constants, the return tuple and the ValueError /
IOError behaviour follow ``meshflow_tpu/api.py:54-273``.  One pipeline
runs every clip, from a frame source into a frame sink, with two
drivers:

* ``_stabilize_frames(frames)``: a clip on the device (``DeviceFrames``):
  every window and block is a slice of the caller's frames, and the
  cropped blocks go into one output made once.
* ``stabilize(in, out)``: a clip on the host (``streaming.HostFrames``: a
  path or an ``ArrayClip`` in, a path or a writer out), with the stream's
  device and host budgets, its decode and encode threads and
  checkpoint/resume of pass 1.  MESHFLOW_STREAM=0, or ``visualize=True``,
  decodes the whole clip, runs ``_stabilize_frames`` and encodes; then
  ``visualize`` shows each input frame above its output
  (``_display_loop``).  Decode and encode go through the native libav
  library when it loads, else cv2 (``io.video``).

The pipeline, its stages as the stage timer names them:

pass 1 (span ``stream.pass1``), windows of CHUNK frames with a one-frame
  halo: ``detect``: above the track pixel budget, d x d box-downscaled
  track planes (motion.trackscale; d=3 at 1080p), under
  track_planes="gray" (or MESHFLOW_TRACK_PLANES=gray) their exact cv2
  gray, one plane; then gray and FAST per subframe (motion.pipeline).
  ``motion``: LK over the window's adjacent pairs (kernel A, or C under
  MESHFLOW_LK_FETCH=band), RANSAC, propagation; at the end the cumsum,
  velocities and homographies scaled back to full resolution.  A
  checkpoint (``checkpoint.py``) of pass 1's outputs lets a rerun start
  at the solve.
pass 2 (span ``stream.pass2``): ``solver``: adaptive weights and banded
  Jacobi.  ``warp+crop``: the crop scan (per CHUNK block the backward
  maps, kernel B, and their crop edges, intersected: the video's crop
  from the displacement fields alone), then per block the warp through
  its maps and the crop + stretch, at full resolution on the BGR frames.
  ``metrics`` per block: cropping ratio and distortion (the LK kernel
  again, at track geometry: on box-downscaled cropped frames, or, for gray
  planes at d=1, on the gray planes warped through the block's maps and
  crop); stability once, from the solved path.

Stages are timed by ``utils.profiling.StageTimer`` (``last_timer``), and
each call is a request of the span recorder (``utils/profiling.py``):
``stabilize`` or ``clip`` its root.  Online mode is ``online.py``; the
frame-sharded and multi-clip paths are ``parallel/``.
"""

from __future__ import annotations

import dataclasses
import os
import weakref

import torch

from meshflow_tpu_torch import checkpoint as ckpt_mod
from meshflow_tpu_torch import config as cfg
from meshflow_tpu_torch import streaming
from meshflow_tpu_torch.config import MeshFlowConfig, validate_adaptive_weights_definition
from meshflow_tpu_torch.io import video as video_io
from meshflow_tpu_torch.kernels.fast import Keypoints
from meshflow_tpu_torch.metrics.quality import cropping_and_distortion, stability_score
from meshflow_tpu_torch.motion import trackscale
from meshflow_tpu_torch.motion.pipeline import (
    MotionEstimate,
    integrate_velocities,
    pair_velocities,
    prepare_frames,
)
from meshflow_tpu_torch.render.stabilize import (
    block_crop,
    crop_frames,
    intersect_crops,
    render_block,
    stabilized_maps,
)
from meshflow_tpu_torch.solver.jacobi import jacobi_smooth
from meshflow_tpu_torch.solver.weights import adaptive_weights
from meshflow_tpu_torch.utils import graphs, grid, prng, profiling
from meshflow_tpu_torch.utils.profiling import StageTimer


def default_device() -> str:
    """The port runs on the card unless the caller asks for the CPU
    (``device="cpu"``); without a card the default fails as torch does."""
    return "cuda"


class DeviceFrames:
    """A clip on the device as the pipeline's frame source and sink
    (``streaming.HostFrames`` is the host's): windows and blocks are slices
    of `frames`, never copies, and each cropped block goes into `out`.
    There is no host work, so nothing runs beside the calling thread."""

    def __init__(self, frames: torch.Tensor, out: torch.Tensor):
        self.frames, self.out = frames, out
        self.num_frames, self.height, self.width = frames.shape[:3]

    def window(self, start: int, stop: int):
        """Frames [start, stop), or None when none follows the halo."""
        return self.frames[start:stop] if start + min(start, 1) < self.num_frames else None

    def blocks(self, num_frames: int, chunk: int):
        for start in range(0, num_frames, chunk):
            yield start, self.frames[start : start + chunk]

    def put(self, start: int, cropped: torch.Tensor) -> None:
        self.out[start : start + cropped.shape[0]] = cropped

    def finish(self) -> None:
        pass

    abort = finish


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
        (cropping_ratio, distortion_score, stability_score).  The streamed
        route also takes a clip object (``streaming.ArrayClip``) in and a
        writer (``streaming.CaptureWriter``) out."""
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
                result = self._stream(input_path, output_path, adaptive_weights_definition,
                                      timer)
            else:
                result, shown = self._stabilize_in_memory(
                    input_path, output_path, adaptive_weights_definition, timer)
        timer.report()
        if shown is not None:
            self._display_loop(*shown)
        return result

    def _stream(self, clip, output, adaptive_weights_definition, timer):
        """``stabilize``'s default route: the pipeline from a clip on the
        host into `output`.  With checkpoint_dir, pass 1's motion state
        persists: a rerun of the same clip and config, also under another
        variant, resumes at the solve."""
        if isinstance(clip, (str, os.PathLike)):
            clip = streaming.FileClip(clip)
        ckpt_path = None
        if self.checkpoint_dir:
            if clip.path is None:
                raise ValueError("checkpoint_dir needs a clip with a path")
            ckpt_path = ckpt_mod.cache_path(self.checkpoint_dir, clip.path, self.config,
                                            int(self._key[-1]), self.device)
        frames = streaming.HostFrames(clip, output, self.device, timer)
        scores = self._clip(frames, adaptive_weights_definition, timer, ckpt_path)
        return tuple(float(s) for s in scores)

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
            frames = torch.as_tensor(frames).to(self.device)
            if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 3:
                raise ValueError("frames must be (F, H, W, 3) uint8 BGR")
            out = torch.empty_like(frames)
            scores = self._clip(DeviceFrames(frames, out), adaptive_weights_definition, timer)
        return (out, *scores)

    # -- the clip pipeline ----------------------------------------------
    def _clip(self, frames, adaptive_weights_definition: int, timer, ckpt_path=None):
        """The pipeline over `frames` (``DeviceFrames`` or
        ``streaming.HostFrames``): pass 1, or its checkpoint at
        `ckpt_path`, then pass 2.  Returns (cropping_ratio,
        distortion_score, stability_score) tensors; the first two are NaN
        in serving mode."""
        num_frames = frames.num_frames
        chunk = min(self.CHUNK, num_frames) if num_frames >= 2 else self.CHUNK
        loaded = ckpt_mod.load_motion(ckpt_path) if ckpt_path else None
        if loaded is not None and loaded.displacements.shape[0] == num_frames:
            state = [torch.from_numpy(a).to(self.device) for a in loaded]
            motion, keypoints = MotionEstimate(*state[:3]), Keypoints(*state[3:])
        else:  # none, or one of another clip length under the same key
            with profiling.span("stream.pass1"):
                motion, keypoints = self._pass1(frames, chunk, timer)
            if ckpt_path:
                ckpt_mod.save_motion(ckpt_path, ckpt_mod.MotionCheckpoint(
                    *(a.cpu().numpy() for a in (*motion, *keypoints))))
        with profiling.span("stream.pass2"):
            return self._pass2(frames, motion, keypoints, adaptive_weights_definition, chunk,
                               timer)

    def _pass1(self, frames, chunk: int, timer):
        """Detect and track the clip window by window: (motion at full
        resolution, the keypoints of every frame).  Windows of `chunk`
        frames overlap by one frame (the halo), whose keypoints the window
        before found; pair t draws its RANSAC samples from
        fold_in(fold_in(key, 1), t)."""
        config = self.config
        h, w = frames.height, frames.width
        th, tw = config.track_shape(h, w)
        key = prng.fold_in(self._key, 1)
        kps_parts, pair_parts, halo = [], [], None
        start = 0
        while (window := frames.window(start, start + chunk)) is not None:
            with timer.stage("detect"):
                track = trackscale.to_track_planes_dev(window, config)
                kps, _ = prepare_frames(track[min(start, 1):], config)
            kps_parts.append(kps)
            if halo is not None:
                kps = Keypoints(*(torch.cat(p) for p in zip(halo, kps)))
            if window.shape[0] >= 2:
                with timer.stage("motion"):
                    pair_parts.append(pair_velocities(kps, track, key, start, config, th, tw,
                                                      self._runner))
            halo = Keypoints(*(a[-1:] for a in kps))
            start += max(window.shape[0] - 1, 1)
        with timer.stage("motion"):
            motion = integrate_velocities(*(torch.cat(p) for p in zip(*pair_parts)))
            if config.resolve_track_downscale(h, w) > 1:
                sx, sy = trackscale.scale_factors(h, w, config)
                motion = motion._replace(
                    displacements=trackscale.scale_velocities(motion.displacements, sx, sy),
                    homographies=trackscale.conjugate_homographies(
                        motion.homographies, sx, sy),
                )
        return motion, Keypoints(*(torch.cat(p) for p in zip(*kps_parts)))

    def _pass2(self, frames, motion, keypoints, adaptive_weights_definition: int, chunk: int,
               timer):
        """Solve, crop scan, then each block rendered, cropped, scored and
        put out: (cropping_ratio, distortion_score, stability_score)."""
        config, device = self.config, self.device
        h, w = frames.height, frames.width
        th, tw = config.track_shape(h, w)
        num_frames = motion.displacements.shape[0]  # the frames pass 1 read
        unstab_grid = grid.vertex_grid(config, h, w, device=device)
        with timer.stage("solver"):
            lambdas = adaptive_weights(motion.homographies, w, h, adaptive_weights_definition)
            stab_disp = jacobi_smooth(motion.displacements, lambdas,
                                      config.temporal_smoothing_radius,
                                      config.optimization_num_iterations)
        # The video's crop is the intersection of the blocks' crops, known
        # before any block is rendered.
        with timer.stage("warp+crop"):
            crop = intersect_crops([
                block_crop(stabilized_maps(motion.displacements[s : s + chunk],
                                           stab_disp[s : s + chunk], unstab_grid, config,
                                           h, w), h, w)
                for s in range(0, num_frames, chunk)
            ])
        # Exposed for inspection: the last run's motion state and crop.
        self.last_motion, self.last_crop = motion, crop
        # Gray planes at full size: the metric pass re-renders them through
        # the block's maps and the crop (the JAX package's default metric
        # source); otherwise it takes the track planes of the cropped output.
        rerender = trackscale.metric_rerender(config, h, w)
        metric_key = prng.fold_in(self._key, 2)
        ratios, distortions = [], []
        try:
            for start, block in frames.blocks(num_frames, chunk):
                sl = slice(start, start + block.shape[0])
                with timer.stage("warp+crop"):
                    track = trackscale.planes_dev(block, config) if rerender else None
                    stab, stab_track = render_block(block, track, motion.displacements[sl],
                                                    stab_disp[sl], unstab_grid, config, h, w)[1:]
                    cropped = crop_frames(stab, crop, h, w)
                    if rerender:
                        cropped_track = crop_frames(stab_track, crop, h, w)
                    del stab, stab_track
                if config.compute_metrics:
                    with timer.stage("metrics"):
                        if not rerender:
                            track = trackscale.to_track_planes_dev(block, config)
                            cropped_track = trackscale.to_track_planes_dev(cropped, config)
                        r, d = cropping_and_distortion(
                            Keypoints(*(a[sl] for a in keypoints)), track, cropped_track,
                            metric_key, start, config, th, tw, self._runner)
                    ratios.append(r)
                    distortions.append(d)
                frames.put(start, cropped)
            frames.finish()
        except BaseException:
            frames.abort()
            raise
        stability = stability_score(stab_disp)
        if not config.compute_metrics:
            nan = torch.tensor(float("nan"), device=device)
            return nan, nan, stability
        return torch.cat(ratios).mean(), torch.cat(distortions).amin(), stability

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
