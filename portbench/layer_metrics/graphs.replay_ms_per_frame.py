"""Device ms of the stage-timed clip's CUDA graph replays, a frame: the
sum of the ``graph.replay:<unit>`` spans' device intervals (CUDA events
at the span's entry and exit: input copies, the graph, output clones)."""

from portbench import spans


def read(ctx):
    request = spans.clip_request(ctx)
    replays = [] if request is None else spans.graph_replays(request)
    if not replays or any(s.device_ms is None for s in replays):
        return None
    return sum(s.device_ms for s in replays) / ctx["frames"]
