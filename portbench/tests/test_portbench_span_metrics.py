"""The readers of the program's span record (``portbench/spans.py`` and
the four span metrics under ``layer_metrics/``): None without a record, or
against a program without the recorder, and the right value from a record
made by hand: a clip's from the stage-timed clip (recorded without the
profiler), the online frames' from the profiled frames."""

import pytest
import torch

from meshflow_tpu_torch.utils import profiling
from portbench.run import read_layer_metric
from portbench.tests.layout import BENCH

CLIP = ("syncs_per_frame", "render.host_ms_per_frame", "graphs.replay_ms_per_frame")
ONLINE = ("online.syncs_per_frame",)
SUMMARY = {"frames": 3}  # the trace's summary: only its presence and frame count matter


def request(root, parts, device=torch.device("cuda"), profiled=False):
    """A resolved request: `parts` (name, parent, host ms, device ms, syncs),
    the root first."""
    req = profiling.Request(7, device, profiled)
    for i, (name, parent, host_ms, device_ms, syncs) in enumerate([(root, None, 50.0, 40.0, 0)]
                                                                  + parts):
        span = profiling.Span(name, i, parent, req.id)
        span.host_start_ns, span.host_end_ns = 1000, 1000 + int(host_ms * 1e6)
        span.device_ms, span.syncs = device_ms, syncs
        req.spans.append(span)
    return req


def clip_record():
    return [
        request("clip", [("warp+crop", 0, 7.5, 6.0, 0), ("render.warp", 1, 5.0, 4.0, 600),
                         ("motion", 0, 3.0, 9.0, 0),
                         ("graph.replay:motion_batch", 3, 0.5, 2.0, 0),
                         ("graph.replay:metric_batch", 0, 0.25, 1.0, 3)]),
        request("clip", [("warp+crop", 0, 30.0, 6.0, 600)], profiled=True),  # the profiled clip
        request("clip", [("warp+crop", 0, 1.0, 1.0, 9)], device=None),  # a CPU clip
    ]


def online_record():
    frames = []
    for i in range(3):
        frames.append(request("online.frame", [
            ("online.upload", 0, 0.2, 0.1, 1), ("online.step", 0, 1.0, 12.0, 0),
            ("graph.replay:_step", 2, 0.4, 12.0, 0),
            ("online.download", 0, 0.2, 0.1, 1 + (i == 2))], profiled=True))
    return [request("online.frame", [("online.upload", 0, 0.2, 0.1, 5)], profiled=True)] + frames


@pytest.fixture
def record(monkeypatch):
    made = []
    monkeypatch.setattr(profiling, "requests", lambda: list(made))
    return made


def read(name, loop, summary=SUMMARY):
    return read_layer_metric(BENCH, name, {"loop": loop, "frames": 10, "summary": summary})


@pytest.mark.parametrize("name", CLIP + ONLINE)
def test_none_without_a_record(record, name):
    loop = "closed" if name in CLIP else "open"
    assert read(name, loop) is None
    record.extend(clip_record() + online_record())
    assert read(name, loop, summary=None) is None  # no trace in the run
    assert read(name, "open" if name in CLIP else "closed") is None  # the other loop


@pytest.mark.parametrize("name", CLIP + ONLINE)
def test_none_from_a_program_without_the_recorder(monkeypatch, name):
    monkeypatch.delattr(profiling, "requests")
    assert read(name, "closed" if name in CLIP else "open") is None


def test_clip_readers_take_the_stage_timed_card_clip(record):
    record.extend(clip_record())
    assert read("syncs_per_frame", "closed") == pytest.approx(603 / 10)
    assert read("render.host_ms_per_frame", "closed") == pytest.approx(7.5 / 10)
    assert read("graphs.replay_ms_per_frame", "closed") == pytest.approx(3.0 / 10)
    record[0].spans[4].device_ms = None  # unresolved: no device number
    assert read("graphs.replay_ms_per_frame", "closed") is None


def test_online_readers_take_the_traced_frames(record):
    record.extend(online_record())
    assert read("online.syncs_per_frame", "open") == pytest.approx(7 / 3)
    assert read("online.syncs_per_frame", "open", summary={"frames": 4}) == pytest.approx(
        12 / 4)
