"""What every kernel wrapper does around its kernel: the routing test, the
checks of its CUDA tensors, the call of its C entry point and the count
of its launches."""

from __future__ import annotations

import collections
import contextlib
import ctypes

import torch

from meshflow_tpu_torch.kernels import _build


# The launches of a CUDA graph's capture, while one is recorded: a
# captured launch runs only when the graph replays.
_captured: collections.Counter | None = None


def count(wrapper) -> None:
    """Add one to `wrapper.launches` where the wrapper launches its kernel,
    or, inside ``recording()``, to the capture's count instead (the graph
    runner adds that count at every replay, ``utils/graphs.py``).
    No lock: only a process's calling thread launches (the stream's decode
    and encode threads launch nothing), and the batch's workers and the
    sharded path's shards are processes of their own, whose counts the
    parent adds in as their answers arrive (``parallel/workers.py``)."""
    if _captured is not None:
        _captured[wrapper] += 1
    else:
        wrapper.launches += 1


@contextlib.contextmanager
def recording():
    """Count the block's launches into the Counter it yields, not into the
    wrappers: the launches of a graph's capture."""
    global _captured
    saved, _captured = _captured, collections.Counter()
    try:
        yield _captured
    finally:
        _captured = saved


def add(launched: collections.Counter) -> None:
    """Add a recorded count to the wrappers: a replay's launches."""
    for wrapper, n in launched.items():
        wrapper.launches += n


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: the wrapper then takes its
    plain version."""
    return all(t.device.type == "cpu" for t in tensors)


def require(name: str, *specs, align: int = 16) -> torch.device:
    """Raise ValueError unless every (tensor, dtype, shape) of `specs` lies
    on one CUDA device with that dtype and shape, contiguous and `align`-byte
    aligned (16 by default: most kernels load 16 bytes at a time).  Returns
    the device."""
    device = specs[0][0].device
    for t, dtype, shape in specs:
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: tensors must be on one CUDA device, got {t.device}")
        if (
            t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % align
        ):
            raise ValueError(
                f"{name}: expected a contiguous, {align}-byte aligned {dtype} tensor of "
                f"shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
            )
    return device


def c_args(args) -> list:
    """The C values of an entry point's arguments: a tensor becomes its data
    pointer, a Python float stays a float (the entry point's argtypes make
    it a C float), anything else (ints, bools) an int."""
    return [
        ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
        else float(a) if isinstance(a, float)
        else int(a)
        for a in args
    ]


def stream_of(device: torch.device) -> ctypes.c_void_p:
    """The current CUDA stream of `device`, as the entry points take it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the library's C entry point `entry` with `args` converted by
    `c_args`, then `device`'s current stream; raise if it returns a CUDA
    error.  The entry points run on the calling thread's current device
    (they query it for their launch shape), so `device` is made current
    around the call: a shard or a batch worker on another card than the
    current one launches on its own."""
    with torch.cuda.device(device):
        _build.check(getattr(_build.library(), entry)(*c_args(args), stream_of(device)), entry)
