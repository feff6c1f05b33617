"""Kernel launches plus CUDA graph launches the host issued over the
traced online frames (the profiler's runtime calls), a frame."""


def read(ctx):
    summary = ctx.get("summary")
    if summary is None or ctx["loop"] != "open" or not summary["frames"]:
        return None
    return (summary["launches"] + summary["graph_launches"]) / summary["frames"]
