"""Share of the shared-memory slots the traced call took that the pool
kept from an earlier call: 100 x spans ``batch.slot:kept`` over
``batch.slot:kept`` plus ``batch.slot:new`` in the parent's
``batch.call``.  None where the program opens neither span."""

from portbench import batch_spans


def read(ctx):
    kept = len(batch_spans.named(ctx.get("call_requests"), "batch.slot:kept"))
    new = len(batch_spans.named(ctx.get("call_requests"), "batch.slot:new"))
    if kept + new == 0:
        return None
    return 100.0 * kept / (kept + new)
