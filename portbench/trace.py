"""Reduce a ``torch.profiler`` trace of the card to the numbers the
per-layer metrics read.

The harness marks the traced span with a ``portbench.window`` annotation,
each online frame with ``portbench.frame`` and each stage of the port's
stage timer with ``stage:<name>`` (``loops.LabeledTimer``).  From the
events it keeps the device's busy time (the union of kernel, copy and
memset intervals), each kernel's device time by name, the launches the
host issued (runtime calls that launch a kernel, and graph launches), and
the idle gaps of the device labelled by what the host thread was doing:
the stage and the innermost operation running when the gap began.
"""

from __future__ import annotations

import collections
import re

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return out


def _clip(merged, lo, hi):
    return [[max(s, lo), min(e, hi)] for s, e in merged if e > lo and s < hi]


def _gaps(busy, regions):
    """The parts of `regions` (merged) that `busy` (merged) leaves free."""
    gaps = []
    for lo, hi in regions:
        cur = lo
        for s, e in _clip(busy, lo, hi):
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < hi:
            gaps.append((cur, hi))
    return gaps


def _label_gaps(gaps, host_events):
    """Seconds of idle device time by host label: the outermost stage
    annotation and the innermost host event open when each gap began."""
    host_events.sort(key=lambda ev: (ev[0], -ev[1]))
    by_label = collections.Counter()
    stack, i = [], 0
    for g0, g1 in sorted(gaps):
        while i < len(host_events) and host_events[i][0] <= g0:
            stack = [ev for ev in stack if ev[1] > host_events[i][0]]
            stack.append(host_events[i])
            i += 1
        stack = [ev for ev in stack if ev[1] > g0]
        stage = next((ev[2][6:] for ev in stack if ev[2].startswith("stage:")), "-")
        inner = next((ev[2] for ev in reversed(stack)
                      if not ev[2].startswith(("stage:", "portbench."))), "host")
        by_label[f"{stage} | {inner}"] += (g1 - g0) * 1e-9
    return by_label


def _kind(ev, name: str) -> str:
    """The event's activity kind (``kernel``, ``gpu_memcpy``, ``cuda_runtime``,
    ``cpu_op``, ...): the profiler's own where it says, else from the
    device and the name."""
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type()).split(".")[-1].lower()
    user = bool(ev.is_user_annotation()) if hasattr(ev, "is_user_annotation") else False
    if str(ev.device_type()).endswith("CUDA"):
        if user or name.startswith(("portbench.", "stage:")):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if re.match(r"cu[A-Z]|cuda[A-Z]", name):
        return "cuda_runtime"
    return "user_annotation" if user or name.startswith(("portbench.", "stage:")) else "cpu_op"


def summarize(prof) -> dict:
    """The traced span's summary: window_s, busy_s, kernels ({name: device
    s}), kernel_counts ({name: runs}), launches and graph_launches (host
    calls), frames (online frame spans), region_s and region_busy_s (the
    frames' spans, else the window, and the device's busy time in them),
    idle_gaps ({label: s})."""
    events = prof.profiler.kineto_results.events()
    window, frames, device, host = None, [], [], []
    launches = graph_launches = 0
    for ev in events:
        name = ev.name()
        kind = _kind(ev, name)
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if kind in DEVICE_KINDS:
            device.append((start, end, name))
        elif kind in ("cuda_runtime", "cuda_driver"):
            if "GraphLaunch" in name:
                graph_launches += 1
            elif "LaunchKernel" in name or "LaunchCooperativeKernel" in name:
                launches += 1
        elif kind in ("cpu_op", "user_annotation"):
            if name == "portbench.window":
                window = (start, end, ev.start_thread_id())
            elif name == "portbench.frame":
                frames.append((start, end))
            host.append((start, end, name, ev.start_thread_id()))
    if window is None:
        raise RuntimeError("the trace has no portbench.window span")
    lo, hi, tid = window
    host = [(s, e, n) for s, e, n, t in host if t == tid and e > lo and s < hi]
    busy = _clip(_merge((s, e) for s, e, _ in device), lo, hi)
    kernels, counts = collections.Counter(), collections.Counter()
    for s, e, name in device:
        if e > lo and s < hi:
            kernels[name] += (e - s) * 1e-9
            counts[name] += 1
    regions = _merge(frames) if frames else [[lo, hi]]
    region_busy = sum(e - s for r0, r1 in regions for s, e in _clip(busy, r0, r1))
    return {
        "window_s": (hi - lo) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "kernels": dict(kernels),
        "kernel_counts": dict(counts),
        "launches": launches,
        "graph_launches": graph_launches,
        "frames": len(frames),
        "region_s": sum(r1 - r0 for r0, r1 in regions) * 1e-9,
        "region_busy_s": region_busy * 1e-9,
        "idle_gaps": dict(_label_gaps(_gaps(busy, regions), host)),
    }


def _named(full: str, names) -> bool:
    """Whether a trace's kernel name is one of `names`: the bare name, or
    the name after a namespace or a return type, with template arguments
    and a parameter list."""
    return any(full == name or re.search(r"(?:^|[\s:])" + re.escape(name) + r"(?:<.*>)?\(", full)
               for name in names)


def kernel_seconds(summary: dict, names) -> float:
    """Device seconds of the kernels that `names` names (``_named``)."""
    return sum(s for full, s in summary["kernels"].items() if _named(full, names))


def kernel_count(summary: dict, names) -> int:
    """How many times the kernels that `names` names ran."""
    return sum(n for full, n in summary["kernel_counts"].items() if _named(full, names))


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, `top` of each, as [name, seconds] pairs."""
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[name[:160], s] for name, s in gaps]}

