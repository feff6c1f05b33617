"""Kernel launches plus CUDA graph launches the host issued over the
profiled clip (the profiler's runtime calls), a frame."""


def read(ctx):
    summary = ctx.get("summary")
    if summary is None or ctx["loop"] != "closed":
        return None
    return (summary["launches"] + summary["graph_launches"]) / ctx["frames"]
