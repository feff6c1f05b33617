"""The LK kernel's share of its roofline over the profiled clip: the
summed bound of its launches (``roofline.lk_bound_s``, from the steps the
reference's own LK took on the same clip) over the device time of the
kernels named here, in %."""

from portbench import roofline, trace

KERNELS = ("lk_level_kernel", "lk_band_kernel")


def read(ctx):
    summary, work = ctx.get("summary"), ctx.get("lk_work")
    if summary is None or not work:
        return None
    seconds = trace.kernel_seconds(summary, KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * roofline.lk_bound_s(work) / seconds
