"""CUDA graph captures the workers made over the window's calls, per
finished clip (``usage["graphs"]``, the workers' ``GraphRunner`` counts):
each job's stabilizer captures its batches' graphs again."""


def read(ctx):
    clips = ctx.get("window_clips")
    if not clips or ctx.get("window_captures") is None:
        return None
    return ctx["window_captures"] / clips
