"""The reader ``batch.slot_reuse_share`` on the CPU: against plain
records, and in a traced run of the tiny batch cell, whose traced call
follows the window's calls of the same clips and so keeps every slot."""

import pytest

from portbench.tests.test_portbench_batch import batch_ctx, execute, layout, read, span

__all__ = ["layout"]  # the tiny batch cell's fixture, shared with its module

NAME = "batch.slot_reuse_share"


def test_slot_reuse_share_on_plain_records():
    """100 x kept slots over the slots the traced call took; None where
    the call opened no slot span (a program without slots)."""
    ctx = batch_ctx()
    spans = ctx["call_requests"][0]["spans"]
    assert read(NAME, ctx) is None
    spans[2:2] = [span("batch.slot:kept", 1, 0, 1) for _ in range(4)]
    assert read(NAME, ctx) == pytest.approx(100.0)
    spans[2:4] = [span("batch.slot:new", 1, 0, 1) for _ in range(2)]
    assert read(NAME, ctx) == pytest.approx(50.0)


def test_none_where_nothing_was_recorded():
    assert read(NAME, {"loop": "closed", "frames": 10, "summary": None}) is None
    empty = dict(batch_ctx(), setup_requests=[], call_requests=[], worker_requests=[],
                 window_clips=0)
    assert read(NAME, empty) is None


def test_traced_run_keeps_every_slot(layout):
    line = execute(layout, trace=True)
    assert line["correct"], line["checks"]
    assert line["metrics"][NAME]["value"] == 100.0
