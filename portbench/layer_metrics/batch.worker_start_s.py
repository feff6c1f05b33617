"""Seconds from the worker pool's start to every worker's ready message
(span ``batch.pool_start`` of the set-up: the spawned processes' imports
of torch and the port and their devices made current)."""

from portbench import batch_spans


def read(ctx):
    found = batch_spans.named(ctx.get("setup_requests"), "batch.pool_start")
    if not found:
        return None
    return batch_spans.host_ms(found[-1]) / 1000
