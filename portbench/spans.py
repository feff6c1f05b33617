"""The program's span record as the per-layer readers take it
(``meshflow_tpu_torch.utils.profiling.requests()``).  A program without
the recorder, or a run without a trace, gives nothing.

A clip's intervals come from the stage-timed clip, the one pass of a
traced run that records without the profiler (the program records the
calls that an enabled stage timer times): the profiler slows the host
and stretches what the spans time.  Sync counts do not depend on it, so
the online frames are the profiled ones."""

from __future__ import annotations


def _record():
    from meshflow_tpu_torch.utils import profiling

    read = getattr(profiling, "requests", None)
    return [] if read is None else read()


def clip_request(ctx):
    """The stage-timed clip's request (the last ``clip`` root on the card
    recorded without a profiler), or None."""
    if ctx.get("loop") != "closed" or ctx.get("summary") is None:
        return None
    found = [r for r in _record()
             if r.root.name == "clip" and r.device is not None and not r.profiled]
    return found[-1] if found else None


def online_frames(ctx) -> list:
    """The traced online frames' requests (``online.frame`` roots on the
    card, the last as many as the trace holds frames)."""
    summary = ctx.get("summary")
    if ctx.get("loop") != "open" or summary is None or not summary["frames"]:
        return []
    found = [r for r in _record() if r.root.name == "online.frame" and r.device is not None]
    return found[-summary["frames"]:]


def graph_replays(request) -> list:
    """The request's graph replay spans (``graph.replay:<unit>``)."""
    return request.named("graph.replay:")
