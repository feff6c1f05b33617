"""Two-pass streaming pipeline, O(chunk) pixel residency at any clip
length: the port of ``meshflow_tpu/streaming.py``.

Only displacement fields, homographies and keypoints (O(F) small tensors)
persist across the clip; pixels flow through in blocks of CHUNK frames,
twice.  The stages:

pass 1 (decode -> device):  stride-(CHUNK-1) windows with a one-frame halo
    feed detection and the pair scan (LK through kernel A, or C under
    MESHFLOW_LK_FETCH=band; RANSAC; propagation).  Windows, RANSAC keys and
    the integration of the velocities are those of the in-memory route
    (``api.MeshFlowStabilizer._stabilize_frames``), so the motion is the
    same.  A checkpoint (``checkpoint.py``) saves pass 1's outputs; a rerun
    that finds it starts at the solve.
solve (device):  adaptive weights and banded Jacobi over the (F, V, 2)
    state, as in-memory.
crop scan (device):  the global crop from the displacement fields alone:
    per CHUNK block, the backward maps (kernel B) and their crop edges,
    intersected over the blocks as in-memory; no pixels are needed.  (The
    JAX package scans on the host with its native renderer, which the
    port leaves behind.)
pass 2 (host -> device -> host):  per CHUNK block, the frames come from
    the device-resident prefix (MESHFLOW_HBM_FRAME_BUDGET_GB), else from
    pass 1's host cache (MESHFLOW_HOST_FRAME_CACHE_GB), else from a second
    decode; the block is warped on the device (kernel B again), cropped and
    stretched with the global crop, scored by the metric pass (none in
    serving mode; gray planes at d=1 warped through the block's maps, as
    in-memory), and its cropped BGR goes back to the host and on to the
    encoder.  Under track_planes="gray" the blocks stay BGR on the device
    and the trackers take their gray planes, derived there.

Pass 1 is the span ``stream.pass1`` and the solve, crop scan and pass 2
the span ``stream.pass2`` (``utils/profiling.py``), under the
``stabilize`` request of ``MeshFlowStabilizer.stabilize``.

Every block of pass 2 is the in-memory route's block, so the output
frames and the three metrics equal ``_stabilize_frames``' bit for bit.
MESHFLOW_INFLIGHT bounds how many pass-1 windows the host queues ahead of
the card.  MESHFLOW_HOST_PIPELINE=serial|threaded|auto: threaded puts
decode and encode on threads of their own, beside the main thread that
drives the device, with bounded queues between them; auto is threaded on
a host with two or more cores.  A worker's exception is raised in the
caller, never left to hang the pipeline.

The clip is a path (decoded by ``ChunkReader``: the native library when it
loads, else cv2) or any object with ``info()`` and ``reader()``
(``ArrayClip``: frames in memory, no codec).  The output is a path
(``StreamWriter``) or any object with ``write(frames)`` and ``close()``
(``CaptureWriter``).
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from meshflow_tpu_torch import checkpoint as ckpt_mod
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.io import native as native_io
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

STAGES = (
    "decode", "host->device", "detect+motion", "motion (sync)", "solver", "crop scan",
    "warp+crop", "metrics", "device->host", "encode",
)


class ChunkReader:
    """Sequential frame reader: native (prefetch thread) or cv2.

    close(check=True) raises the reference's IOError on a short clip."""

    def __init__(self, path: str):
        self.path = path
        self._native = None
        self._cv = None
        if native_io.available():
            self._native = native_io.NativeReader(path)
            self.num_frames = self._native.num_frames
        else:
            import cv2

            self._cv = cv2.VideoCapture(path)
            if not self._cv.isOpened():
                self._cv.release()
                raise IOError(f"Could not open video at <{path}>.")
            self.num_frames = int(self._cv.get(cv2.CAP_PROP_FRAME_COUNT))
        self._read = 0

    def read(self, n: int) -> np.ndarray:
        """Up to n frames, (m, H, W, 3) uint8 (m = 0 at the end)."""
        if self._native is not None:
            batch = self._native.read(n)
        else:
            frames = []
            while len(frames) < n:
                ok, frame = self._cv.read()
                if not ok:
                    break
                frames.append(frame)
            batch = np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)
        self._read += len(batch)
        return batch

    def close(self, check: bool = False) -> None:
        if self._native is not None:
            self._native.close()
        if self._cv is not None:
            self._cv.release()
        if check and self.num_frames and self._read < self.num_frames:
            raise IOError(
                f"Video at <{self.path}> did not have frame {self._read} of "
                f"{self.num_frames} (indexed from 0)."
            )


class StreamWriter:
    """Incremental encoder with ``io.video.write_video``'s codec fallbacks."""

    def __init__(self, path: str, width: int, height: int, fps: float, fourcc: int):
        self.path = path
        self._native = None
        self._cv = None
        if native_io.available():
            try:
                self._native = native_io.NativeWriter(path, width, height, fps, fourcc)
            except IOError:
                self._native = None
        if self._native is None:
            self._cv = video_io.open_cv2_writer(path, width, height, fps, fourcc)

    def write(self, frames: np.ndarray) -> None:
        if self._native is not None:
            if self._native.write(frames) != len(frames):
                raise IOError(f"Native encoder failed for <{self.path}>.")
            return
        for frame in frames:
            self._cv.write(np.ascontiguousarray(frame))

    def close(self) -> None:
        if self._native is not None:
            rc = self._native.close()
            self._native = None
            if rc != 0:
                raise IOError(f"Native encoder failed for <{self.path}>.")
        if self._cv is not None:
            self._cv.release()
            self._cv = None


class FileClip:
    """A video file as the pipeline's clip."""

    def __init__(self, path: str):
        self.path = str(path)

    def info(self) -> video_io.VideoInfo:
        return video_io.probe_video(self.path)

    def reader(self) -> ChunkReader:
        return ChunkReader(self.path)


class _ArrayReader:
    def __init__(self, frames: np.ndarray):
        self.frames, self._pos = frames, 0

    def read(self, n: int) -> np.ndarray:
        batch = np.ascontiguousarray(self.frames[self._pos : self._pos + n])
        self._pos += len(batch)
        return batch

    def close(self, check: bool = False) -> None:
        pass


class ArrayClip:
    """(F, H, W, 3) uint8 BGR frames in memory as the pipeline's clip: no
    codec.  `path`, when given, names a file that stands for the clip in
    checkpoint keys (its path, size and mtime)."""

    def __init__(self, frames: np.ndarray, fps: float = 30.0, path: Optional[str] = None):
        self.frames, self.fps, self.path = frames, fps, path

    def info(self) -> video_io.VideoInfo:
        f, h, w = self.frames.shape[:3]
        return video_io.VideoInfo(f, self.fps, 0, h, w)

    def reader(self) -> _ArrayReader:
        return _ArrayReader(self.frames)


class CaptureWriter:
    """An output that keeps the cropped frames it is given, in memory."""

    def __init__(self):
        self.batches = []

    def write(self, frames: np.ndarray) -> None:
        self.batches.append(np.array(frames))

    def close(self) -> None:
        pass

    def frames(self) -> np.ndarray:
        return np.concatenate(self.batches)


def resident_end(parts) -> int:
    """Frames [0, end) covered by a contiguous (start, array) part list."""
    if not parts:
        return 0
    start, arr = parts[-1]
    return start + arr.shape[0]


def resident_slice(parts, start: int, n: int):
    """Frames [start, start + n) of a contiguous (start, array) part list
    (tensors or numpy arrays), without concatenating the whole clip; at
    most two parts overlap a block."""
    out = []
    for p0, arr in parts:
        p1 = p0 + arr.shape[0]
        if p1 <= start or p0 >= start + n:
            continue
        out.append(arr[max(start, p0) - p0 : min(start + n, p1) - p0])
    if len(out) == 1:
        return out[0]
    return np.concatenate(out) if isinstance(out[0], np.ndarray) else torch.cat(out)


class _Acc:
    """Per-stage wall-clock buckets, reported into a StageTimer.  With the
    timer enabled on a CUDA device, each timed section ends with a
    synchronize, so a bucket holds its stage's device time."""

    def __init__(self, timer, device: torch.device):
        self.timer = timer
        self.device = device
        self.sync = timer.enabled and device.type == "cuda"
        self.buckets: dict = {}
        self._lock = threading.Lock()  # decode and encode threads add too

    def add(self, name: str, start: float, device_work: bool = True) -> None:
        if self.sync and device_work:
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - start
        with self._lock:
            self.buckets[name] = self.buckets.get(name, 0.0) + seconds

    def flush(self) -> None:
        for name in STAGES:
            if name in self.buckets:
                self.timer.stages.append((name, self.buckets[name]))


def _budget(name: str, default_gb: float) -> int:
    return int(float(os.environ.get(name, default_gb)) * (1 << 30))


def _host_cache_budget() -> int:
    """MESHFLOW_HOST_FRAME_CACHE_GB, or 8 GiB capped at a quarter of RAM."""
    if os.environ.get("MESHFLOW_HOST_FRAME_CACHE_GB") is not None:
        return _budget("MESHFLOW_HOST_FRAME_CACHE_GB", 0)
    budget = 8 << 30
    try:
        budget = min(budget, os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") // 4)
    except (ValueError, OSError, AttributeError):
        pass
    return budget


def _threaded() -> bool:
    mode = os.environ.get("MESHFLOW_HOST_PIPELINE", "auto")
    return mode == "threaded" or (mode == "auto" and (os.cpu_count() or 1) >= 2)


class _Pass1(NamedTuple):
    motion: MotionEstimate
    keypoints: Keypoints
    frame_parts: list  # (start, device frames): the resident prefix
    host_cache: Optional[list]  # (start, numpy frames) covering the clip, or None


def stabilize_streamed(
    clip,
    output,
    adaptive_weights_definition: int,
    config: MeshFlowConfig,
    key: torch.Tensor,
    timer,
    device,
    chunk: int = 64,
    checkpoint_dir: Optional[str] = None,
    runner: Optional[graphs.GraphRunner] = None,
):
    """Stream `clip` (a path or an ``ArrayClip``) to `output` (a path or a
    writer); returns (cropping_ratio, distortion_score, stability_score).

    checkpoint_dir persists pass 1's motion state: a rerun of the same
    clip and config, also under another variant, resumes at the solve.
    runner: the motion and metric batches run through it
    (``MeshFlowStabilizer.stabilize`` passes its own; None runs them
    directly).
    """
    device = torch.device(device)
    if isinstance(clip, (str, os.PathLike)):
        clip = FileClip(clip)
    info = clip.info()
    num_frames = info.num_frames
    chunk = min(chunk, num_frames) if num_frames >= 2 else chunk
    acc = _Acc(timer, device)

    ckpt_path, loaded = None, None
    if checkpoint_dir:
        if clip.path is None:
            raise ValueError("checkpoint_dir needs a clip with a path")
        ckpt_path = ckpt_mod.cache_path(
            checkpoint_dir, clip.path, config, int(key[-1]), device
        )
        loaded = ckpt_mod.load_motion(ckpt_path)
        if loaded is not None and loaded.displacements.shape[0] != num_frames:
            loaded = None  # another clip length under the same key: recompute

    if loaded is not None:
        def dev(a):
            return torch.from_numpy(a).to(device)

        state = _Pass1(
            MotionEstimate(dev(loaded.displacements), dev(loaded.homographies),
                           dev(loaded.pair_ok)),
            Keypoints(dev(loaded.kp_positions), dev(loaded.kp_scores), dev(loaded.kp_valid)),
            [], None,
        )
    else:
        with profiling.span("stream.pass1", device=device):
            state = _pass1(clip, info, config, key, device, chunk, acc, runner)
        if ckpt_path:
            motion, kps = state.motion, state.keypoints
            ckpt_mod.save_motion(ckpt_path, ckpt_mod.MotionCheckpoint(
                *(a.cpu().numpy() for a in (motion.displacements, motion.homographies,
                                            motion.pair_ok, kps.positions, kps.scores,
                                            kps.valid))
            ))
    with profiling.span("stream.pass2", device=device):
        result = _solve_and_render(clip, output, info, adaptive_weights_definition, config,
                                   key, device, chunk, acc, state, runner)
    acc.flush()
    return result


def _pass1(clip, info, config, key, device, chunk, acc, runner=None) -> _Pass1:
    """Decode, detect and track the clip window by window."""
    h, w = info.height, info.width
    d_track = config.resolve_track_downscale(h, w)
    th, tw = config.track_shape(h, w)
    hbm_budget = _budget("MESHFLOW_HBM_FRAME_BUDGET_GB", 4)
    clip_bytes = info.num_frames * h * w * 3
    host_cache = [] if 0 < clip_bytes <= _host_cache_budget() else None
    max_inflight = int(os.environ.get("MESHFLOW_INFLIGHT", "2"))
    key_motion = prng.fold_in(key, 1)
    reader = clip.reader()
    frame_parts, kept = [], 0
    kps_parts, vel_parts, homo_parts, ok_parts = [], [], [], []
    halo = None  # (track planes, keypoints) of the last frame of the last window
    read, inflight = 0, collections.deque()
    while True:
        t0 = time.perf_counter()
        batch = reader.read(chunk if halo is None else chunk - 1)
        acc.add("decode", t0, device_work=False)
        if batch.shape[0] == 0:
            break
        n = batch.shape[0]
        if host_cache is not None:
            host_cache.append((read, batch))
        t0 = time.perf_counter()
        frames = torch.from_numpy(batch).to(device)
        acc.add("host->device", t0)

        t0 = time.perf_counter()
        track = trackscale.to_track_planes_dev(frames, config)
        kps, _ = prepare_frames(track, config)
        kps_parts.append(kps)
        if hbm_budget > 0 and kept < hbm_budget:
            frame_parts.append((read, frames))
            kept += frames.numel()
        if halo is not None:
            track = torch.cat([halo[0], track])
            kps = Keypoints(*(torch.cat(p) for p in zip(halo[1], kps)))
        if track.shape[0] >= 2:
            vel, homo, ok = pair_velocities(kps, track, key_motion, read - 1 if halo else 0,
                                            config, th, tw, runner)
            vel_parts.append(vel)
            homo_parts.append(homo)
            ok_parts.append(ok)
        # copies, so that the window's tensors are freed with it
        halo = (track[-1:].clone(), Keypoints(*(a[-1:].clone() for a in kps)))
        read += n
        if device.type == "cuda":
            inflight.append(torch.cuda.Event())
            inflight[-1].record(torch.cuda.current_stream(device))
            if len(inflight) > max_inflight:
                inflight.popleft().synchronize()
        acc.add("detect+motion", t0)
    reader.close(check=True)

    t0 = time.perf_counter()
    motion = integrate_velocities(torch.cat(vel_parts), torch.cat(homo_parts),
                                  torch.cat(ok_parts))
    if d_track > 1:
        sx, sy = trackscale.scale_factors(h, w, config)
        motion = motion._replace(
            displacements=trackscale.scale_velocities(motion.displacements, sx, sy),
            homographies=trackscale.conjugate_homographies(motion.homographies, sx, sy),
        )
    keypoints = Keypoints(*(torch.cat(p) for p in zip(*kps_parts)))
    acc.add("motion (sync)", t0)
    return _Pass1(motion, keypoints, frame_parts, host_cache)


class _Pipeline:
    """The host side of pass 2: where each block's frames come from, and
    the encoder, serial or on threads of their own (``_threaded``)."""

    def __init__(self, clip, writer, chunk, num_frames, res_end, host_cache, acc):
        self.clip, self.writer, self.chunk = clip, writer, chunk
        self.num_frames, self.res_end, self.host_cache, self.acc = (
            num_frames, res_end, host_cache, acc)
        self.reader, self.pos = None, 0
        self.errors, self.cancel = [], threading.Event()
        self.threads = []
        self.q_dec: queue.Queue = queue.Queue(maxsize=2)
        self.q_enc: queue.Queue = queue.Queue(maxsize=2)

    def host_frames(self, start: int, n: int) -> Optional[np.ndarray]:
        """Block [start, start + n) from the host: None when it lies in the
        device-resident prefix, else from the host cache, else decoded
        (skipping frames the reader has not reached)."""
        if start + n <= self.res_end:
            return None
        t0 = time.perf_counter()
        if self.host_cache is not None:
            frames = resident_slice(self.host_cache, start, n)
        else:
            if self.reader is None:
                self.reader = self.clip.reader()
            parts = []
            while self.pos < start + n:
                if self.pos < start:  # the resident prefix: decoded and dropped
                    got = len(self.reader.read(min(self.chunk, start - self.pos)))
                else:
                    parts.append(self.reader.read(start + n - self.pos))
                    got = len(parts[-1])
                if got == 0:
                    raise IOError(f"Video at <{self.clip.path}> did not have frame "
                                  f"{self.pos} of {self.num_frames} (indexed from 0).")
                self.pos += got
            frames = parts[0] if len(parts) == 1 else np.concatenate(parts)
        self.acc.add("decode", t0, device_work=False)
        return frames

    def encode(self, frames: np.ndarray) -> None:
        t0 = time.perf_counter()
        self.writer.write(frames)
        self.acc.add("encode", t0, device_work=False)

    # -- threaded: decode | main (device) | encode ---------------------------
    def _put(self, q, item) -> bool:
        while not self.cancel.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def _sentinel(self, q) -> None:
        """Deliver the end-of-stream None even mid-abort: a stage's error
        path sets cancel, which must not swallow its own sentinel and leave
        the downstream get() blocked.  After cancel, stale items are evicted
        to make room (without cancel this is a plain blocking put)."""
        while True:
            try:
                q.put(None, timeout=0.25)
                return
            except queue.Full:
                if self.cancel.is_set():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass

    def _decode_stage(self) -> None:
        try:
            for start in range(0, self.num_frames, self.chunk):
                n = min(self.chunk, self.num_frames - start)
                if not self._put(self.q_dec, (start, n, self.host_frames(start, n))):
                    return
        except BaseException as e:  # raised in the main thread
            self.errors.append(e)
            self.cancel.set()
        finally:
            self._sentinel(self.q_dec)

    def _encode_stage(self) -> None:
        try:
            while True:
                frames = self.q_enc.get()
                if frames is None:
                    return
                self.encode(frames)
        except BaseException as e:
            self.errors.append(e)
            self.cancel.set()

    def blocks(self):
        """(start, n, host frames or None) for every block, in order."""
        if not _threaded():
            for start in range(0, self.num_frames, self.chunk):
                n = min(self.chunk, self.num_frames - start)
                yield start, n, self.host_frames(start, n)
            return
        self.threads = [threading.Thread(target=fn, daemon=True)
                        for fn in (self._decode_stage, self._encode_stage)]
        for t in self.threads:
            t.start()
        while True:
            item = self.q_dec.get()
            if item is None:
                break
            yield item
        if self.errors:
            raise self.errors[0]

    def put_output(self, frames: np.ndarray) -> None:
        if not self.threads:
            self.encode(frames)
        elif not self._put(self.q_enc, frames):
            raise self.errors[0]

    def finish(self) -> None:
        if self.threads:
            self._sentinel(self.q_enc)
            for t in self.threads:
                t.join()
        self._close_reader()
        if self.errors:
            raise self.errors[0]
        t0 = time.perf_counter()
        self.writer.close()
        self.acc.add("encode", t0, device_work=False)

    def abort(self) -> None:
        """Stop the threads and release the reader and the encoder; the
        caller re-raises its error."""
        self.cancel.set()
        for q in (self.q_dec, self.q_enc):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        for t in self.threads:
            t.join(timeout=10.0)
        self._close_reader()
        try:
            self.writer.close()
        except IOError:
            pass  # the original error is the one to raise

    def _close_reader(self) -> None:
        if self.reader is not None:
            self.reader.close()
            self.reader = None


def _solve_and_render(clip, output, info, adaptive_weights_definition, config, key, device,
                      chunk, acc, state: _Pass1, runner=None):
    """Solve, crop scan and pass 2 (shared by fresh and resumed runs)."""
    h, w = info.height, info.width
    num_frames = state.motion.displacements.shape[0]  # the frames pass 1 read
    th, tw = config.track_shape(h, w)
    motion, keypoints = state.motion, state.keypoints
    unstab_grid = grid.vertex_grid(config, h, w, device=device)

    t0 = time.perf_counter()
    lambdas = adaptive_weights(motion.homographies, w, h, adaptive_weights_definition)
    stab_disp = jacobi_smooth(motion.displacements, lambdas,
                              config.temporal_smoothing_radius,
                              config.optimization_num_iterations)
    acc.add("solver", t0)

    t0 = time.perf_counter()
    crop = intersect_crops([
        block_crop(stabilized_maps(motion.displacements[s : s + chunk],
                                   stab_disp[s : s + chunk], unstab_grid, config, h, w), h, w)
        for s in range(0, num_frames, chunk)
    ])
    acc.add("crop scan", t0)

    if isinstance(output, (str, os.PathLike)):
        output = StreamWriter(str(output), w, h, info.fps, info.fourcc)
    pipe = _Pipeline(clip, output, chunk, num_frames, resident_end(state.frame_parts),
                     state.host_cache, acc)
    metric_key = prng.fold_in(key, 2)
    rerender = trackscale.metric_rerender(config, h, w)
    ratios, distortions = [], []
    try:
        for start, n, host in pipe.blocks():
            sl = slice(start, start + n)
            t0 = time.perf_counter()
            if host is None:
                frames = resident_slice(state.frame_parts, start, n)
            else:
                frames = torch.from_numpy(host).to(device)
            acc.add("host->device", t0)
            t0 = time.perf_counter()
            # the block's maps go with render_block, before the metric
            # pass's working set
            track = trackscale.planes_dev(frames, config) if rerender else None
            stab, stab_t, _ = render_block(frames, track, motion.displacements[sl],
                                           stab_disp[sl], unstab_grid, config, h, w)
            cropped = crop_frames(stab, crop, h, w)
            if rerender:
                cropped_t = crop_frames(stab_t, crop, h, w)
            del stab, stab_t
            acc.add("warp+crop", t0)
            if config.compute_metrics:
                t0 = time.perf_counter()
                if rerender:
                    unstab_t = track
                else:
                    unstab_t = trackscale.to_track_planes_dev(frames, config)
                    cropped_t = trackscale.to_track_planes_dev(cropped, config)
                r, d = cropping_and_distortion(
                    Keypoints(*(a[sl] for a in keypoints)), unstab_t, cropped_t,
                    metric_key, start, config, th, tw, runner,
                )
                ratios.append(r)
                distortions.append(d)
                acc.add("metrics", t0)
            t0 = time.perf_counter()
            cropped_np = cropped.cpu().numpy()
            acc.add("device->host", t0)
            pipe.put_output(cropped_np)
        pipe.finish()
    except BaseException:
        pipe.abort()
        raise

    stability = stability_score(stab_disp)
    if config.compute_metrics:
        cropping_ratio = torch.cat(ratios).mean()
        distortion = torch.cat(distortions).amin()
    else:
        cropping_ratio = distortion = torch.tensor(float("nan"))
    return float(cropping_ratio), float(distortion), float(stability)
