"""ctypes bindings for the native libav video I/O library: the port's own
loader of ``native/libmeshflow_videoio.so``, mirroring
``meshflow_tpu/io/native.py``.

The library is committed at ``native/`` in the root of the checkout and is
loaded as it is (never rebuilt here).  It decodes with a background
prefetch thread, so decode overlaps device work, and encodes with libav.
When it loads, ``io.video`` and ``streaming`` read and write through it;
otherwise they fall back to cv2.  ``load_error()`` says why it did not
load: the loader's ``OSError`` text, or "absent".
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libmeshflow_videoio.so"

_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def load_library() -> Optional[ctypes.CDLL]:
    """The loaded library with its signatures set, or None (see
    ``load_error``).  A failed load is not retried."""
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    if not LIB_PATH.exists():
        _error = "absent"
        return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError as e:
        _error = str(e)
        return None
    p, i, u, d, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_double, ctypes.c_long
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mf_reader_open.restype = p
    lib.mf_reader_open.argtypes = [ctypes.c_char_p]
    lib.mf_reader_info.argtypes = [
        p, ctypes.POINTER(i), ctypes.POINTER(i), ctypes.POINTER(d),
        ctypes.POINTER(n), ctypes.POINTER(u),
    ]
    lib.mf_reader_read.restype = n
    lib.mf_reader_read.argtypes = [p, u8p, n]
    lib.mf_reader_close.argtypes = [p]
    lib.mf_writer_open.restype = p
    lib.mf_writer_open.argtypes = [ctypes.c_char_p, i, i, d, u]
    lib.mf_writer_write.restype = n
    lib.mf_writer_write.argtypes = [p, u8p, n]
    lib.mf_writer_close.restype = i
    lib.mf_writer_close.argtypes = [p]
    _lib = lib
    return lib


def load_error() -> Optional[str]:
    """Why the library did not load (None when it loaded or was not tried)."""
    return _error


def available() -> bool:
    return load_library() is not None


def _require() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise IOError(f"native video IO library not loaded: {_error}")
    return lib


class NativeReader:
    """Streaming decoder with background prefetch."""

    def __init__(self, path: str):
        self._lib = _require()
        self._handle = self._lib.mf_reader_open(path.encode())
        if not self._handle:
            raise IOError(f"Could not open video at <{path}>.")
        w, h = ctypes.c_int(), ctypes.c_int()
        fps, nb, fourcc = ctypes.c_double(), ctypes.c_long(), ctypes.c_uint()
        self._lib.mf_reader_info(
            self._handle, ctypes.byref(w), ctypes.byref(h), ctypes.byref(fps),
            ctypes.byref(nb), ctypes.byref(fourcc),
        )
        self.width, self.height = w.value, h.value
        self.fps = fps.value
        self.num_frames = nb.value
        self.fourcc = int(fourcc.value)

    def read(self, max_frames: int) -> np.ndarray:
        """Up to max_frames BGR frames, (n, H, W, 3) uint8 (n = 0 at the end)."""
        buf = np.empty((max_frames, self.height, self.width, 3), np.uint8)
        got = self._lib.mf_reader_read(
            self._handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_frames
        )
        return buf[:got]

    def close(self) -> None:
        if self._handle:
            self._lib.mf_reader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeWriter:
    """Encoder of (n, H, W, 3) uint8 BGR batches."""

    def __init__(self, path: str, width: int, height: int, fps: float, fourcc: int):
        self._lib = _require()
        self._handle = self._lib.mf_writer_open(
            path.encode(), width, height, fps, fourcc & 0xFFFFFFFF
        )
        if not self._handle:
            raise IOError(f"Could not open a video encoder for <{path}>.")

    def write(self, frames: np.ndarray) -> int:
        """Encode a batch; returns the frames written."""
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        return self._lib.mf_writer_write(
            self._handle, frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            frames.shape[0],
        )

    def close(self) -> int:
        """Flush and close; returns the library's status (0 = success)."""
        if self._handle:
            rc = self._lib.mf_writer_close(self._handle)
            self._handle = None
            return rc
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
