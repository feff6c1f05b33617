"""The span records of a batch run as the per-layer readers take them.

The batch loop (``loops/batch.py``) hands the readers plain records
(``meshflow_tpu_torch.utils.profiling.plain``): the parent's set-up
(``setup_requests``: the pool's start), the parent's traced call
(``call_requests``: the ``batch.call`` request) and each worker's
requests of that call (``worker_requests``, one list a worker, the jobs'
``stabilize`` requests).  Host intervals are ``perf_counter_ns`` of one
host's monotonic clock, so the parent's and the workers' compare.  A run
of another loop, or of a program that records nothing, gives nothing."""

from __future__ import annotations


def named(requests, name: str) -> list:
    """Every span called `name` in the records."""
    return [s for r in requests or [] for s in r["spans"] if s["name"] == name]


def host_ms(span) -> float:
    return (span["host_end_ns"] - span["host_start_ns"]) * 1e-6


def call_span(ctx):
    """The traced call's ``batch.call`` span, or None."""
    found = named(ctx.get("call_requests"), "batch.call")
    return found[-1] if found else None


def jobs(ctx) -> list:
    """The traced call's jobs: every worker's ``stabilize`` requests."""
    return [r for requests in ctx.get("worker_requests") or [] for r in requests
            if r["root"] == "stabilize"]


def job_device_ms_per_frame(ctx, name: str):
    """Per job of the traced call, the device ms of its span `name`, a
    frame; None where a job lacks the span or its device interval."""
    out = []
    for request in jobs(ctx):
        found = [s for s in request["spans"] if s["name"] == name]
        if not found or any(s["device_ms"] is None for s in found):
            return None
        out.append(sum(s["device_ms"] for s in found) / ctx["frames"])
    return out or None
