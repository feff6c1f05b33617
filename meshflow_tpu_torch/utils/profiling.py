"""Stage timing and the program's spans: the port of
``meshflow_tpu/utils/profiling.py``, grown into a span recorder.

Enable the timing report: MESHFLOW_TIMINGS=1 (prints a per-stage table).
An enabled timer also records the spans of the call it times, so the
table gives each stage's device ms and host syncs beside its wall time.
Enable device traces: MESHFLOW_TRACE_DIR=/path (one Chrome trace per
run of a stage, ``<stage>.json`` and ``<stage>.<k>.json`` for its k-th
run after the first, recorded by ``torch.profiler``).

PyTorch returns before the card finishes, so an enabled timer on a CUDA
device ends every stage with ``torch.cuda.synchronize()``; a disabled
timer, or one on the CPU, never synchronizes.

Spans.  ``span(name)`` marks a layer boundary.  The recorder is on while
a ``torch.profiler`` records, inside ``recording()``, or for a call that
an enabled ``StageTimer`` times; otherwise a span call is one flag check
and returns a shared no-op.  A span with no open parent on its thread is
the root of a request (one clip, one ``stabilize`` call, one online
frame), and every span of the tree shares the request's id.  Each span keeps:

* its name, its parent (index in the request) and the request's id;
* its host interval (``time.perf_counter_ns``);
* on a CUDA request, its device interval: a pair of CUDA events recorded
  on the device's current stream at entry and exit, taken from a pool
  that ended requests give back.  Nothing synchronizes while a request
  is recorded; ``requests()`` resolves the events when it is called;
* the host syncs made while it was the innermost span: the root of a
  CUDA request turns on ``torch.cuda.set_sync_debug_mode("warn")`` and
  counts PyTorch's warnings ("called a synchronizing CUDA operation")
  until it ends, then puts the previous mode back (a previous "error"
  mode stays: the sync raises, as it would unrecorded; under a previous
  "warn" the warnings are still shown); syncs the recorder and the stage
  timer make themselves (``uncounted()``) do not count.

A request records whether a profiler was on (``Request.profiled``): the
profiler slows the host, and with it the spans' host and device
intervals (a graph's launch most: the online step's replay reads twice
its device time under it), so readers of intervals take requests
recorded without one.

While a profiler records, each span is also a
``torch.profiler.record_function("meshflow.<name>")`` range, so that its
trace shows the program's spans beside the device's activity.  The
record keeps the last ``RECORD_REQUESTS`` ended requests, in memory only.
A span must never open inside a unit that a CUDA graph captures: the
runner (``utils/graphs.py``) opens its spans around the capture and the
replay.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _torch_profiler

# Ended requests the record keeps (the oldest goes first): above the 100
# online frames a traced run records, a few clips' worth of spans.
RECORD_REQUESTS = 256

SYNC_WARNING = "called a synchronizing CUDA operation"

_switch = 0  # depth of open recording() blocks
_record: collections.deque = collections.deque()
_ids = itertools.count()
_thread = threading.local()  # .stack: the thread's open spans; .quiet: syncs not counted
_events: Dict[torch.device, list] = {}  # free CUDA events by device
_streams: Dict[tuple, object] = {}  # (device index, raw handle) -> torch.cuda.Stream
_hook_lock = threading.Lock()
_hook_users = 0
_hook_saved = None


class _Off:
    """The shared no-op of a span or recording() with the recorder off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Span:
    """One recorded span.  Times: ``host_start_ns``/``host_end_ns`` from
    ``time.perf_counter_ns``; ``device_start_ms`` (from the root's entry)
    and ``device_ms`` from the CUDA events, None on the CPU or before
    ``requests()`` resolved them."""

    __slots__ = ("name", "index", "parent", "request", "host_start_ns", "host_end_ns",
                 "device_start_ms", "device_ms", "syncs", "_start", "_end")

    def __init__(self, name: str, index: int, parent: Optional[int], request: int):
        self.name, self.index, self.parent, self.request = name, index, parent, request
        self.host_start_ns = self.host_end_ns = 0
        self.device_start_ms = self.device_ms = None
        self.syncs = 0
        self._start = self._end = None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) * 1e-6

    def __repr__(self):
        return (f"Span({self.name!r}, parent={self.parent}, request={self.request}, "
                f"host_ms={self.host_ms:.3f}, device_ms={self.device_ms}, syncs={self.syncs})")


class Request:
    """The spans of one request, root first, in the order they opened;
    ``profiled``: a profiler was recording as the root opened."""

    __slots__ = ("id", "device", "profiled", "spans")

    def __init__(self, request_id: int, device: Optional[torch.device], profiled: bool):
        self.id, self.device, self.profiled, self.spans = request_id, device, profiled, []

    @property
    def root(self) -> Span:
        return self.spans[0]

    def named(self, name: str) -> List[Span]:
        """The spans called `name`, or, for a name ending in ``:``, every
        span whose name starts with it (``graph.replay:``)."""
        if name.endswith(":"):
            return [s for s in self.spans if s.name.startswith(name)]
        return [s for s in self.spans if s.name == name]

    @property
    def syncs(self) -> int:
        return sum(s.syncs for s in self.spans)

    def _resolve(self) -> None:
        """Device intervals from the spans' events; the events go back to
        the pool."""
        base = self.root._start
        if base is None:
            return
        with uncounted():
            for s in self.spans:
                if s._start is None:
                    continue
                s._end.synchronize()
                s.device_start_ms = base.elapsed_time(s._start)
                s.device_ms = s._start.elapsed_time(s._end)
            self._release()

    def _release(self) -> None:
        for s in self.spans:
            if s._start is not None:
                _events.setdefault(self.device, []).extend((s._start, s._end))
                s._start = s._end = None


def _recorded(device: torch.device):
    """A pooled CUDA event, recorded on `device`'s current stream.  Each
    stream's object is kept by its raw handle: ``torch.cuda.current_stream``
    costs more host time than the record."""
    free = _events.get(device)
    event = free.pop() if free else torch.cuda.Event(enable_timing=True)
    key = (device.index, torch._C._cuda_getCurrentRawStream(device.index))
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream(device)
    event.record(stream)
    return event


def _hook(on: bool) -> None:
    """Count host syncs through PyTorch's sync debug mode while any CUDA
    request is open."""
    global _hook_users, _hook_saved
    with _hook_lock:
        if on:
            if not _hook_users:
                _hook_saved = _hooked()
            _hook_users += 1
        else:
            _hook_users -= 1
            if not _hook_users:
                caught, mode = _hook_saved
                _hook_saved = None
                torch.cuda.set_sync_debug_mode(mode)
                caught.__exit__(None, None, None)


def _hooked():
    """Turn the sync hook on: (the warnings' saved state, the previous
    mode).  A previous "error" mode stays; under "warn" the warnings are
    still shown."""
    mode = torch.cuda.get_sync_debug_mode()
    caught = warnings.catch_warnings()
    caught.__enter__()
    try:
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        warnings.filterwarnings("always", message=SYNC_WARNING)
        show = warnings.showwarning

        def counted(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(SYNC_WARNING):
                stack = getattr(_thread, "stack", None)
                if stack and not getattr(_thread, "quiet", 0):
                    stack[-1].syncs += 1
                if mode != 1:
                    return None
            return show(message, category, filename, lineno, file, line)

        warnings.showwarning = counted
        if mode == 0:
            torch.cuda.set_sync_debug_mode("warn")
    except BaseException:
        caught.__exit__(None, None, None)
        raise
    return caught, mode


class _Live:
    """An open span while the recorder is on."""

    __slots__ = ("span", "req", "root", "annotation")

    def __init__(self, name: str, device):
        stack = getattr(_thread, "stack", None)
        if stack is None:
            stack = _thread.stack = []
        if stack:
            parent = stack[-1]
            self.req = _thread.request
            self.root = False
        else:
            parent = None
            device = None if device is None else torch.device(device)
            if device is None or device.type != "cuda":
                device = None
            elif device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            self.req = Request(next(_ids), device, _torch_profiler._is_profiler_enabled)
            self.root = True
        self.span = Span(name, len(self.req.spans), None if parent is None else parent.index,
                         self.req.id)
        self.annotation = (torch.profiler.record_function("meshflow." + name)
                           if _torch_profiler._is_profiler_enabled else _OFF)

    def __enter__(self) -> Span:
        req, span = self.req, self.span
        self.annotation.__enter__()
        try:
            if req.device is not None:
                span._start = _recorded(req.device)
                if self.root:
                    _hook(True)  # last: a failed entry leaves the mode as it was
        except BaseException:
            self.annotation.__exit__(None, None, None)
            raise
        if self.root:
            _thread.request = req
        req.spans.append(span)
        _thread.stack.append(span)
        span.host_start_ns = time.perf_counter_ns()
        return span

    def __exit__(self, *exc):
        req, span = self.req, self.span
        span.host_end_ns = time.perf_counter_ns()
        if span._start is not None:
            span._end = _recorded(req.device)
        _thread.stack.pop()
        self.annotation.__exit__(*exc)
        if self.root:
            _thread.request = None
            if req.device is not None:
                _hook(False)
            if len(_record) >= RECORD_REQUESTS:
                _record.popleft()._release()
            _record.append(req)
        return False


def enabled() -> bool:
    """Whether the recorder is on (a profiler records, or inside
    ``recording()``)."""
    return bool(_switch or _torch_profiler._is_profiler_enabled)


def span(name: str, unit: Optional[str] = None, device=None):
    """A span `name` (``name:unit`` when `unit` is given) around a `with`
    block: the recorder's Span while it is on, else None.  `device`, for
    a root span: the request's device (CUDA events and sync counts only
    on a CUDA device); a span inside a request takes the request's."""
    if not (_switch or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Live(name if unit is None else f"{name}:{unit}", device)


class _Recording:
    __slots__ = ()

    def __enter__(self):
        global _switch
        _switch += 1

    def __exit__(self, *exc):
        global _switch
        _switch -= 1
        return False


_RECORDING = _Recording()


def recording(on: bool = True):
    """The in-process switch: the recorder is on inside the `with` block
    (when `on`), with or without a profiler."""
    return _RECORDING if on else _OFF


@contextlib.contextmanager
def uncounted():
    """Host syncs inside the block count for no span (the recorder's own,
    and the stage timer's)."""
    _thread.quiet = getattr(_thread, "quiet", 0) + 1
    try:
        yield
    finally:
        _thread.quiet -= 1


def requests() -> List[Request]:
    """The record: the last ``RECORD_REQUESTS`` ended requests, oldest
    first, their device intervals resolved (this waits for the device to
    finish their spans)."""
    out = list(_record)
    for req in out:
        req._resolve()
    return out


def plain(requests: List[Request]) -> List[dict]:
    """Resolved `requests` as plain picklable records, the form in which a
    worker process hands its record to its parent: for each request its
    root's name, its device (a string, or None) and ``profiled``, and
    ``spans``, root first, each with its name, parent, host interval in
    ``perf_counter_ns`` (CLOCK_MONOTONIC: comparable across the processes
    of one host), device ms and syncs."""
    return [{"root": r.root.name, "device": None if r.device is None else str(r.device),
             "profiled": r.profiled,
             "spans": [{"name": s.name, "parent": s.parent, "host_start_ns": s.host_start_ns,
                        "host_end_ns": s.host_end_ns, "device_ms": s.device_ms,
                        "syncs": s.syncs} for s in r.spans]}
            for r in requests]


def clear() -> None:
    """Empty the record."""
    while _record:
        _record.popleft()._release()


class StageTimer:
    """Collects per-stage wall times for one run.  Each stage is also a
    span of the same name; a stage that runs more than once (a window, a
    block) adds up, and threads add their host-only stages (decode,
    encode) through ``add``."""

    def __init__(self, enabled: Optional[bool] = None, device=None):
        self.enabled = (
            enabled
            if enabled is not None
            else os.environ.get("MESHFLOW_TIMINGS", "") not in ("", "0")
        )
        self.trace_dir = os.environ.get("MESHFLOW_TRACE_DIR")
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.stages: List[tuple] = []  # (name, seconds), one entry a stage run or add
        self._spans: Dict[str, List[Span]] = {}  # name -> the stage's spans
        self._lock = threading.Lock()

    def _trace(self, name: str):
        """A profiler over one run of the stage: ``<name>.json``, and
        ``<name>.<k>.json`` for its k-th run after the first."""
        if not self.trace_dir:
            return contextlib.nullcontext()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        runs = sum(n == name for n, _ in self.stages)
        base = name.replace(" ", "_") + (f".{runs}" if runs else "")
        path = os.path.join(self.trace_dir, base + ".json")

        def export(prof):
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(path)

        return torch.profiler.profile(activities=activities, on_trace_ready=export)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        with self._trace(name):
            with span(name) as recorded:  # the span leaves out the stage's sync
                yield
            if self.enabled and self.device.type == "cuda":
                with uncounted():
                    torch.cuda.synchronize(self.device)
        if recorded is not None:
            self._spans.setdefault(name, []).append(recorded)
        self.add(name, time.perf_counter() - start)

    def add(self, name: str, seconds: float) -> None:
        """Add `seconds` to stage `name` (from any thread; no span, no
        synchronize)."""
        with self._lock:
            self.stages.append((name, seconds))

    def report(self) -> Dict[str, float]:
        """{stage: seconds}, each stage's runs summed, in the order the
        stages first ran; printed when enabled, with each stage's device ms
        and syncs from its spans."""
        table: Dict[str, float] = {}
        with self._lock:
            for name, seconds in self.stages:
                table[name] = table.get(name, 0.0) + seconds
        if self.enabled:
            if self._spans:
                requests()  # resolves the device intervals of the ended requests
            total = sum(table.values())
            width = max((len(n) for n in table), default=0)
            for name, seconds in table.items():
                line = f"  {name:<{width}}  {seconds:7.2f}s  ({100*seconds/max(total,1e-9):4.1f}%)"
                recorded = self._spans.get(name)
                if recorded:
                    if all(s.device_ms is not None for s in recorded):
                        line += f"  device {sum(s.device_ms for s in recorded):9.2f} ms"
                    line += f"  syncs {sum(s.syncs for s in recorded)}"
                print(line)
            print(f"  {'total':<{width}}  {total:7.2f}s")
        return table
