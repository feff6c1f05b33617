"""Host syncs a traced online frame (each ``process`` call's request; the
program's span recorder counts them through PyTorch's sync debug mode)."""

from portbench import spans


def read(ctx):
    frames = spans.online_frames(ctx)
    if not frames:
        return None
    return sum(r.syncs for r in frames) / len(frames)
