"""Median host-clock ms of one ``process`` call over the window's frames
(call to return, the wait for its due time not counted)."""

import statistics


def read(ctx):
    steps = ctx.get("step_ms")
    if not steps:
        return None
    return statistics.median(steps)
