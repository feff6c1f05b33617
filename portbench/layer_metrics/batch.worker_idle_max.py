"""The largest share, over the workers, of the traced call's host
interval (span ``batch.call``) in which the worker held no job's
``stabilize`` span: the card waits for its worker's next job, the
hand-off or the call's slowest worker."""

from portbench import batch_spans


def read(ctx):
    call = batch_spans.call_span(ctx)
    workers = ctx.get("worker_requests")
    if call is None or not workers:
        return None
    start, end = call["host_start_ns"], call["host_end_ns"]
    idle = []
    for requests in workers:
        busy = sorted((max(s["host_start_ns"], start), min(s["host_end_ns"], end))
                      for s in batch_spans.named(requests, "stabilize"))
        held, reach = 0, start
        for a, b in busy:
            a = max(a, reach)
            if b > a:
                held += b - a
                reach = b
        idle.append(100.0 * (1 - held / (end - start)))
    return max(idle)
