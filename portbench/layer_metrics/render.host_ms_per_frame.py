"""Host ms of the render stage's span (``warp+crop``, the program's span
recorder) in the stage-timed clip, a frame: the render's own host work,
the stage timer's closing sync left out."""

from portbench import spans


def read(ctx):
    request = spans.clip_request(ctx)
    found = [] if request is None else request.named("warp+crop")
    if not found:
        return None
    return sum(s.host_ms for s in found) / ctx["frames"]
