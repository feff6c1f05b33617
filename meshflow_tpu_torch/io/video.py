"""Host-side video decode and encode through OpenCV.

Container handling follows the reference: frame count, fps and fourcc
are read from the input and passed to the writer, and a short read raises
IOError with the reference's message.  cv2 is imported inside the
functions so that the package imports without it.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np


class VideoInfo(NamedTuple):
    num_frames: int
    fps: float
    fourcc: int
    height: int
    width: int


def read_video(input_path: str) -> Tuple[np.ndarray, VideoInfo]:
    """Decode the whole clip -> ((F, H, W, 3) uint8 BGR, VideoInfo)."""
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


def write_video(output_path: str, frames: np.ndarray, fps: float, fourcc: int) -> None:
    """Encode (F, H, W, 3) uint8 BGR with the input's fourcc and fps,
    falling back to mp4v when that encoder is unavailable; raises IOError
    when no encoder opens."""
    import cv2

    height, width = frames.shape[1:3]
    writer = cv2.VideoWriter(output_path, fourcc, fps, (width, height))
    if not writer.isOpened():
        writer.release()
        writer = cv2.VideoWriter(
            output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height)
        )
    if not writer.isOpened():
        writer.release()
        raise IOError(f"Could not open a video encoder for <{output_path}>.")
    try:
        for frame in frames:
            writer.write(np.ascontiguousarray(frame))
    finally:
        writer.release()
