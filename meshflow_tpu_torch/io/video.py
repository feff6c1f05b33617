"""Host-side video decode and encode, routed as ``meshflow_tpu/io/video.py``
routes them: through the native libav library (``io.native``) when it
loads, through OpenCV otherwise.

Container handling follows the reference: frame count, fps and fourcc
are read from the input and passed to the writer, and a short read raises
IOError with the reference's message.  cv2 is imported inside the
functions that use it, so the package imports without it.  Streaming
decode and encode for the two-pass pipeline live in ``streaming.py``
(``ChunkReader``, ``StreamWriter``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from meshflow_tpu_torch.io import native as native_io

READ_BATCH = 128  # frames per native read of read_video


class VideoInfo(NamedTuple):
    num_frames: int
    fps: float
    fourcc: int
    height: int
    width: int


def probe_video(input_path: str) -> VideoInfo:
    """The container's frame count, fps, fourcc and frame size, without
    decoding the clip."""
    if native_io.available():
        reader = native_io.NativeReader(input_path)
        reader.close()
        return VideoInfo(reader.num_frames, reader.fps, reader.fourcc, reader.height,
                         reader.width)
    import cv2

    video = cv2.VideoCapture(input_path)
    if not video.isOpened():
        video.release()
        raise IOError(f"Could not open video at <{input_path}>.")
    info = VideoInfo(
        num_frames=int(video.get(cv2.CAP_PROP_FRAME_COUNT)),
        fps=video.get(cv2.CAP_PROP_FPS),
        fourcc=int(video.get(cv2.CAP_PROP_FOURCC)),
        height=int(video.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        width=int(video.get(cv2.CAP_PROP_FRAME_WIDTH)),
    )
    video.release()
    return info


def _read_native(input_path: str) -> Tuple[np.ndarray, VideoInfo]:
    with native_io.NativeReader(input_path) as reader:
        batches = []
        while True:
            batch = reader.read(READ_BATCH)
            if len(batch) == 0:
                break
            batches.append(batch)
    total = sum(len(b) for b in batches)
    if reader.num_frames and total < reader.num_frames:
        raise IOError(
            f"Video at <{input_path}> did not have frame {total} of "
            f"{reader.num_frames} (indexed from 0)."
        )
    stacked = np.concatenate(batches) if batches else np.zeros((0, 0, 0, 3), np.uint8)
    return stacked, VideoInfo(total, reader.fps, reader.fourcc, reader.height, reader.width)


def read_video(input_path: str) -> Tuple[np.ndarray, VideoInfo]:
    """Decode the whole clip -> ((F, H, W, 3) uint8 BGR, VideoInfo)."""
    if native_io.available():
        return _read_native(input_path)
    import cv2

    video = cv2.VideoCapture(input_path)
    if not video.isOpened():
        video.release()
        raise IOError(f"Could not open video at <{input_path}>.")
    try:
        num_frames = int(video.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = video.get(cv2.CAP_PROP_FPS)
        fourcc = int(video.get(cv2.CAP_PROP_FOURCC))
        frames = []
        for frame_index in range(num_frames):
            ok, frame = video.read()
            if not ok:
                raise IOError(
                    f"Video at <{input_path}> did not have frame {frame_index} of "
                    f"{num_frames} (indexed from 0)."
                )
            frames.append(frame)
    finally:
        video.release()
    stacked = np.stack(frames) if frames else np.zeros((0, 0, 0, 3), np.uint8)
    info = VideoInfo(
        num_frames=num_frames,
        fps=fps,
        fourcc=fourcc,
        height=stacked.shape[1] if num_frames else 0,
        width=stacked.shape[2] if num_frames else 0,
    )
    return stacked, info


def open_cv2_writer(output_path: str, width: int, height: int, fps: float, fourcc: int):
    """A cv2.VideoWriter with the input's fourcc, else mp4v; raises IOError
    when no encoder opens."""
    import cv2

    writer = cv2.VideoWriter(output_path, fourcc, fps, (width, height))
    if not writer.isOpened():
        writer.release()
        writer = cv2.VideoWriter(
            output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height)
        )
    if not writer.isOpened():
        writer.release()
        raise IOError(f"Could not open a video encoder for <{output_path}>.")
    return writer


def write_video(output_path: str, frames: np.ndarray, fps: float, fourcc: int) -> None:
    """Encode (F, H, W, 3) uint8 BGR with the input's fourcc and fps.

    The native libav encoder takes the requested codec (falling back to
    mpeg4 inside the library); a codec or container it cannot open, or no
    native library, goes to cv2 with an mp4v fallback.  Raises IOError when
    no encoder opens or the native encoder fails."""
    height, width = frames.shape[1:3]
    if native_io.available():
        try:
            writer = native_io.NativeWriter(output_path, width, height, fps, fourcc)
        except IOError:
            writer = None  # codec or container outside the library: cv2 below
        if writer is not None:
            try:
                written = writer.write(frames)
            finally:
                rc = writer.close()
            if written != len(frames) or rc != 0:
                raise IOError(f"Native encoder failed for <{output_path}>.")
            return
    writer = open_cv2_writer(output_path, width, height, fps, fourcc)
    try:
        for frame in frames:
            writer.write(np.ascontiguousarray(frame))
    finally:
        writer.release()
