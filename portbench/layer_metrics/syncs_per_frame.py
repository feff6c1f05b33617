"""Host syncs inside the stage-timed clip's ``_stabilize_frames`` call, a
frame: the program's span recorder counts them through PyTorch's sync
debug mode (``utils/profiling.py``), the stage timer's own left out."""

from portbench import spans


def read(ctx):
    request = spans.clip_request(ctx)
    if request is None:
        return None
    return request.syncs / ctx["frames"]
