"""Device ms a frame of the stream's pass 1 (span ``stream.pass1``:
decode, detection and motion), the median over the traced call's jobs."""

import statistics

from portbench import batch_spans


def read(ctx):
    found = batch_spans.job_device_ms_per_frame(ctx, "stream.pass1")
    return None if found is None else statistics.median(found)
