"""The card's idle share over the profiled clip, in %: 100 x (1 - busy /
window), busy the union of its kernels, copies and memsets."""


def read(ctx):
    summary = ctx.get("summary")
    if summary is None or ctx["loop"] != "closed" or summary["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - summary["busy_s"] / summary["window_s"])
