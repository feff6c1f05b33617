"""The backward-map kernels' share of their roofline over the profiled
clip: the bound by bytes of the clip's maps (``roofline.bmap_bound_s``)
over the device time of the table and map kernels named here, in %."""

from portbench import roofline, trace

KERNELS = ("table_kernel", "map_kernel")


def read(ctx):
    summary = ctx.get("summary")
    if summary is None or ctx["loop"] != "closed":
        return None
    seconds = trace.kernel_seconds(summary, KERNELS)
    launches = trace.kernel_count(summary, ("map_kernel",))
    if seconds <= 0 or launches == 0:
        return None
    bound = roofline.bmap_bound_s(ctx["frames"], launches, ctx["vertices"], ctx["height"],
                                  ctx["width"])
    return 100.0 * bound / seconds
