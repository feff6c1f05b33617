"""PyTorch port: its ctypes loader of the native libav library
(``meshflow_tpu_torch/io/native.py``) and the routing of ``io/video.py``,
against the JAX package's loader on a clip written here.

Tolerances: decoding is exact (the port's decode equals the JAX loader's
byte for byte, and the native and cv2 decoders agree on an MJPG clip);
an encode-decode round trip is lossy, within a mean absolute error of 8
grey levels on smooth frames, as ``tests/test_native_io.py`` holds it.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest

from meshflow_tpu.io import native as jax_native

from meshflow_tpu_torch.io import native as native_io
from meshflow_tpu_torch.io import video as video_io
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(
    not jax_native.available(), reason="native video IO library does not load here"
)


def _smooth_frames(n=12, h=96, w=128, seed=3):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(n, h, w, 3), dtype=np.uint8)
    return np.stack([cv2.GaussianBlur(f, (7, 7), 3.0) for f in frames])


def _mjpg_clip(path, frames, fps=24.0):
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()


def test_port_loader_round_trips_a_clip(tmp_path):
    frames = _smooth_frames()
    path = str(tmp_path / "out.mp4")
    video_io.write_video(path, frames, 30.0, 0)
    info = video_io.probe_video(path)
    assert (info.num_frames, info.height, info.width) == (12, 96, 128)
    assert info.fps == pytest.approx(30.0)
    back, read_info = video_io.read_video(path)
    assert back.shape == frames.shape and read_info.num_frames == 12
    assert np.abs(back.astype(int) - frames.astype(int)).mean() < 8.0
    with native_io.NativeReader(path) as reader:
        assert (reader.width, reader.height, reader.num_frames) == (128, 96, 12)
        assert len(reader.read(5)) == 5 and len(reader.read(100)) == 7
        assert len(reader.read(5)) == 0


def test_port_decode_equals_jax_loader(tmp_path):
    path = str(tmp_path / "out.mp4")
    video_io.write_video(path, _smooth_frames(), 30.0, 0)
    ours = native_io.NativeReader(path)
    theirs = jax_native.NativeReader(path)
    try:
        assert (ours.width, ours.height, ours.fps, ours.num_frames, ours.fourcc) == (
            theirs.width, theirs.height, theirs.fps, theirs.num_frames, theirs.fourcc)
        a, b = ours.read(64), theirs.read(64)
    finally:
        ours.close()
        theirs.close()
    assert a.shape == (12, 96, 128, 3)
    np.testing.assert_array_equal(a, b)


def test_read_video_routes_native_then_cv2(tmp_path, monkeypatch):
    """Native when the library loads, cv2 when load_library gives None;
    both decode the MJPG clip to the same bytes."""
    src = tmp_path / "in.avi"
    _mjpg_clip(src, _smooth_frames(n=6, h=64, w=96))
    opened = []

    class Spy(native_io.NativeReader):
        def __init__(self, path):
            opened.append(path)
            super().__init__(path)

    monkeypatch.setattr(native_io, "NativeReader", Spy)
    native, native_info = video_io.read_video(str(src))
    assert opened == [str(src)]
    monkeypatch.setattr(native_io, "load_library", lambda: None)
    assert not native_io.available()
    fallback, fallback_info = video_io.read_video(str(src))
    assert opened == [str(src)]
    np.testing.assert_array_equal(native, fallback)
    assert native_info == fallback_info
    assert video_io.probe_video(str(src)) == fallback_info
    with pytest.raises(IOError):
        video_io.read_video(str(tmp_path / "missing.avi"))


def test_native_missing_file_raises():
    with pytest.raises(IOError, match="Could not open video"):
        native_io.NativeReader("/nonexistent-clip.mp4")


def test_native_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['meshflow_tpu'] = None\n"
        "import meshflow_tpu_torch.io.native as n, meshflow_tpu_torch.io.video\n"
        "import meshflow_tpu_torch.streaming, meshflow_tpu_torch.checkpoint\n"
        "assert n.available(), n.load_error()\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'meshflow_tpu.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_load_error_names_the_reason(monkeypatch, tmp_path):
    """A library that is absent or fails to load leaves its reason."""
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_error", None)
    monkeypatch.setattr(native_io, "LIB_PATH", tmp_path / "absent.so")
    assert native_io.load_library() is None and native_io.load_error() == "absent"
    bad = tmp_path / "bad.so"
    bad.write_bytes(b"not a library")
    monkeypatch.setattr(native_io, "_error", None)
    monkeypatch.setattr(native_io, "LIB_PATH", bad)
    assert native_io.load_library() is None
    assert "bad.so" in native_io.load_error()
    with pytest.raises(IOError, match="not loaded"):
        native_io.NativeReader("/any.mp4")
