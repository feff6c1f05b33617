"""The host side of the clip pipeline (``api.MeshFlowStabilizer``): the
port of ``meshflow_tpu/streaming.py``'s readers, writers, budgets and
host threads, O(chunk) pixel residency at any clip length.

``stabilize`` runs the pipeline over a clip on the host: a path (decoded
by ``ChunkReader``: the native library when it loads, else cv2) or any
object with ``info()``, ``reader()`` and ``path`` (``ArrayClip``: frames
in memory, no codec), into a path (``StreamWriter``) or any object with
``write(frames)`` and ``close()`` (``CaptureWriter``).  ``HostFrames`` is
that clip and output as the pipeline's frame source and sink.  Pixels
flow through in blocks of CHUNK frames, twice:

pass 1:  each window's new frames are decoded and uploaded; the first
    MESHFLOW_HBM_FRAME_BUDGET_GB of them stay on the device (the resident
    prefix), and all of them in host memory when the clip fits
    MESHFLOW_HOST_FRAME_CACHE_GB (the host cache).  MESHFLOW_INFLIGHT
    bounds how many windows the host queues ahead of the card.
pass 2:  each block comes from the resident prefix, else from the host
    cache, else from a second decode; each cropped block goes back to the
    host and on to the encoder.  MESHFLOW_HOST_PIPELINE=serial|threaded|auto:
    threaded puts decode and encode on threads of their own, beside the
    main thread that drives the device, with bounded queues between them;
    auto is threaded on a host with two or more cores.  A worker's
    exception is raised in the caller, never left to hang the pipeline.

Decode and encode are host work, timed into the stage timer with
``StageTimer.add`` from whichever thread runs them; uploads and copies
back are stages of the main thread (``host->device``, ``device->host``).
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from meshflow_tpu_torch.io import native as native_io
from meshflow_tpu_torch.io import video as video_io


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


class HostFrames:
    """A clip and an output on the host as the pipeline's frame source and
    sink (``api.DeviceFrames`` is the device's): ``window`` gives pass 1
    its windows, ``blocks`` gives pass 2 its blocks on the device, ``put``
    sends each cropped block to the encoder, and ``finish`` or ``abort``
    ends the run.  Decode and encode run serial or on threads of their own
    (``_threaded``)."""

    def __init__(self, clip, output, device, timer):
        self.clip, self.output, self.timer = clip, output, timer
        self.device = torch.device(device)
        self.info = clip.info()
        self.num_frames, self.height, self.width = (
            self.info.num_frames, self.info.height, self.info.width)
        self.parts, self.kept = [], 0  # the resident prefix: (start, device frames)
        self.host_cache = None  # (start, numpy frames) covering the clip, or None
        self.reader, self.pos = None, 0
        self.last, self.inflight = None, collections.deque()
        self.writer, self.chunk, self.res_end = None, 0, 0
        self.errors, self.cancel = [], threading.Event()
        self.threads = []
        self.q_dec: queue.Queue = queue.Queue(maxsize=2)
        self.q_enc: queue.Queue = queue.Queue(maxsize=2)

    # -- pass 1 ---------------------------------------------------------------
    def window(self, start: int, stop: int) -> Optional[torch.Tensor]:
        """Frames [start, stop) on the device (fewer at the clip's end), or
        None when no frame follows the halo: frame `start` is the last one
        of the previous window unless `start` is 0.  The new frames are
        decoded and uploaded behind the halo; the clip's length is checked
        once the reader runs dry."""
        if self.reader is None:
            self.reader = self.clip.reader()
            clip_bytes = self.num_frames * self.height * self.width * 3
            self.host_cache = [] if 0 < clip_bytes <= _host_cache_budget() else None
        elif self.device.type == "cuda":  # the previous window's work is queued
            self.inflight.append(torch.cuda.Event())
            self.inflight[-1].record(torch.cuda.current_stream(self.device))
            if len(self.inflight) > int(os.environ.get("MESHFLOW_INFLIGHT", "2")):
                self.inflight.popleft().synchronize()
        t0 = time.perf_counter()
        batch = self.reader.read(stop - self.pos)
        self.timer.add("decode", time.perf_counter() - t0)
        if batch.shape[0] == 0:
            self._close_reader(check=True)
            return None
        if self.host_cache is not None:
            self.host_cache.append((self.pos, batch))
        halo = int(start < self.pos)
        with self.timer.stage("host->device"):
            frames = torch.empty((halo + len(batch),) + batch.shape[1:], dtype=torch.uint8,
                                 device=self.device)
            if halo:
                frames[0] = self.last
            frames[halo:].copy_(torch.from_numpy(batch))
        if self.kept < _budget("MESHFLOW_HBM_FRAME_BUDGET_GB", 4):
            self.parts.append((self.pos, frames[halo:]))
            self.kept += batch.size
        self.last = frames[-1].clone()  # a copy: the window is freed after its work
        self.pos += len(batch)
        return frames

    # -- pass 2 ---------------------------------------------------------------
    def blocks(self, num_frames: int, chunk: int):
        """(start, frames on the device) of each block of `chunk` frames, in
        order: from the resident prefix, else uploaded from the host."""
        self.num_frames, self.chunk = num_frames, chunk
        self.res_end, self.pos = resident_end(self.parts), 0
        self.writer = self.output
        if isinstance(self.output, (str, os.PathLike)):
            self.writer = StreamWriter(str(self.output), self.width, self.height,
                                       self.info.fps, self.info.fourcc)
        for start, n, host in self._host_blocks():
            if host is None:
                yield start, resident_slice(self.parts, start, n)
                continue
            with self.timer.stage("host->device"):
                frames = torch.from_numpy(host).to(self.device)
            yield start, frames

    def put(self, start: int, cropped: torch.Tensor) -> None:
        """The cropped block at `start`, back to the host and to the encoder."""
        with self.timer.stage("device->host"):
            frames = cropped.cpu().numpy()
        if not self.threads:
            self.encode(frames)
        elif not self._put(self.q_enc, frames):
            raise self.errors[0]

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
        self.timer.add("decode", time.perf_counter() - t0)
        return frames

    def encode(self, frames: np.ndarray) -> None:
        t0 = time.perf_counter()
        self.writer.write(frames)
        self.timer.add("encode", time.perf_counter() - t0)

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

    def _host_blocks(self):
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
        self.timer.add("encode", time.perf_counter() - t0)

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
        if self.writer is not None:
            try:
                self.writer.close()
            except IOError:
                pass  # the original error is the one to raise

    def _close_reader(self, check: bool = False) -> None:
        if self.reader is not None:
            reader, self.reader = self.reader, None
            reader.close(check=check)
