"""Device ms a frame of the stream's second pass (span ``stream.pass2``:
the solver, the crop scan, the render and the metrics, blocks back to the
host), the median over the traced call's jobs."""

import statistics

from portbench import batch_spans


def read(ctx):
    found = batch_spans.job_device_ms_per_frame(ctx, "stream.pass2")
    return None if found is None else statistics.median(found)
