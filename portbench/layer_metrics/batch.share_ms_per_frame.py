"""Host ms a frame of the traced call's shared-memory hand-off in the
parent: span ``batch.share_in`` (the clips copied into shared memory) plus
``batch.share_out`` (the captured frames written to the jobs' writers),
over every frame of the call."""

from portbench import batch_spans


def read(ctx):
    spans = (batch_spans.named(ctx.get("call_requests"), "batch.share_in")
             + batch_spans.named(ctx.get("call_requests"), "batch.share_out"))
    if not spans or not ctx.get("call_frames"):
        return None
    return sum(batch_spans.host_ms(s) for s in spans) / ctx["call_frames"]
