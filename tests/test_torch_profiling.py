"""PyTorch port: the span recorder (``utils/profiling.py``) on the CPU.

* Spans nest, with their parents' indices and their request's id; host
  intervals are ordered; the record keeps the last ``RECORD_REQUESTS``
  requests.
* Under ``torch.profiler.profile()`` the recorder is on, each span is a
  ``meshflow.<name>`` event of the profiler and its request is marked
  profiled.
* A span whose entry fails leaves nothing open; the sync hook keeps a
  caller's "warn" or "error" mode and puts the mode and the warning
  filters back.
* With the recorder off, a ``_stabilize_frames`` call and ``process``
  calls record nothing, make no CUDA event and no profiler annotation, and
  never touch the sync debug mode.
* Recorded, a clip is one request (``clip``, its two passes, their
  stages, the render's spans per block) and an online frame another (``online.frame`` and its
  parts); an enabled stage timer records the call it times; the graph
  runner, through ``test_torch_graphs.py``'s CPU stand-in, records its
  warm-ups, captures and replays by unit.

The card's share (device intervals, sync counts) is in
``tests/test_torch_cuda.py``.
"""

import pytest
import torch

from meshflow_tpu_torch.api import MeshFlowStabilizer
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.online import OnlineMeshFlowStabilizer
from meshflow_tpu_torch.utils import graphs, profiling
from meshflow_tpu_torch.utils.profiling import StageTimer
from test_torch_graphs import StandInRunner, _affine
from test_torch_slice import TINY, _clip
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)

H, W, FRAMES = 72, 128, 6


@pytest.fixture(autouse=True)
def empty_record():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture(scope="module")
def frames():
    return _clip(FRAMES, H, W, pan=12)


def _names(request):
    return [s.name for s in request.spans]


def test_spans_nest_with_parents_and_request_ids():
    with profiling.recording():
        with profiling.span("a"):
            with profiling.span("b"):
                with profiling.span("c"):
                    pass
            with profiling.span("d", "unit"):
                pass
        with profiling.span("e"):
            pass
    first, second = profiling.requests()
    assert _names(first) == ["a", "b", "c", "d:unit"] and _names(second) == ["e"]
    assert [s.parent for s in first.spans] == [None, 0, 1, 0]
    assert [s.index for s in first.spans] == [0, 1, 2, 3]
    assert {s.request for s in first.spans} == {first.id} and second.root.request == second.id
    assert second.id > first.id
    assert first.named("b")[0] is first.spans[1] and first.named("d:") == [first.spans[3]]
    assert all(s.device_ms is None and s.syncs == 0 for s in first.spans + second.spans)


def test_host_intervals_are_ordered():
    with profiling.recording():
        with profiling.span("a"):
            for _ in range(3):
                with profiling.span("b"):
                    with profiling.span("c"):
                        torch.ones(64).sum()
    (req,) = profiling.requests()
    for s in req.spans:
        assert 0 < s.host_start_ns <= s.host_end_ns
        if s.parent is not None:
            parent = req.spans[s.parent]
            assert parent.host_start_ns <= s.host_start_ns <= s.host_end_ns <= parent.host_end_ns
    siblings = req.named("b")
    assert all(x.host_end_ns <= y.host_start_ns for x, y in zip(siblings, siblings[1:]))
    assert req.root.host_ms >= sum(s.host_ms for s in siblings)


def test_a_request_records_whether_a_profiler_was_on():
    with profiling.recording(), profiling.span("plain"):
        pass
    with torch.profiler.profile(), profiling.span("profiled"):
        pass
    plain, profiled = profiling.requests()
    assert (plain.profiled, profiled.profiled) == (False, True)


def test_a_failed_entry_leaves_no_open_span_and_no_hook(monkeypatch):
    """The root of a card request opens the sync hook last: an entry that
    fails before it leaves the thread's stack and the mode as they were."""
    hooked = []

    def broken(device):
        raise RuntimeError("no event")

    monkeypatch.setattr(profiling, "_recorded", broken)
    monkeypatch.setattr(profiling, "_hook", hooked.append)
    with profiling.recording():
        with pytest.raises(RuntimeError, match="no event"):
            with profiling.span("root", device=torch.device("cuda", 0)):
                pass
        with profiling.span("next"):  # a new root, not a child of the failed one
            pass
    (req,) = profiling.requests()
    assert req.root.name == "next" and req.root.parent is None and hooked == []


@pytest.mark.parametrize("previous, during, shown", [(0, 1, False), (1, 1, True), (2, 2, False)])
def test_the_sync_hook_keeps_the_callers_mode(monkeypatch, previous, during, shown):
    """Off ("0") the hook warns and counts; a caller's "warn" still sees its
    warnings; a caller's "error" stays (the sync raises, recorded or not);
    the mode and the warning filters are put back."""
    import warnings

    mode = [previous]
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: mode[0])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__(0, {"warn": 1}.get(m, m)))
    seen = []
    monkeypatch.setattr(warnings, "showwarning", lambda *a, **k: seen.append(str(a[0])))
    filters = list(warnings.filters)
    with profiling.recording():
        profiling._hook(True)
        try:
            assert mode[0] == during
            with profiling.span("counted"):
                warnings.warn(profiling.SYNC_WARNING + " (test)")
            warnings.warn("another warning")
        finally:
            profiling._hook(False)
    assert mode[0] == previous and warnings.filters == filters
    assert profiling.requests()[0].syncs == 1
    assert seen == [profiling.SYNC_WARNING + " (test)"] * shown + ["another warning"]


def test_record_keeps_the_last_requests():
    with profiling.recording():
        for i in range(profiling.RECORD_REQUESTS + 3):
            with profiling.span(f"r{i}"):
                pass
    record = profiling.requests()
    assert len(record) == profiling.RECORD_REQUESTS
    assert [r.root.name for r in record[:2]] == ["r3", "r4"]
    assert record[-1].root.name == f"r{profiling.RECORD_REQUESTS + 2}"


def test_spans_are_profiler_events_and_the_profiler_turns_the_recorder_on():
    with torch.profiler.profile() as prof:
        with profiling.span("outer"):
            with profiling.span("inner", "u"):
                torch.ones(8).sum()
    names = {ev.name for ev in prof.events()}
    assert {"meshflow.outer", "meshflow.inner:u"} <= names
    (req,) = profiling.requests()
    assert _names(req) == ["outer", "inner:u"]
    with profiling.span("after"):  # the profiler has stopped: off again
        pass
    assert len(profiling.requests()) == 1


def test_off_records_nothing_and_opens_no_event_or_annotation(monkeypatch, frames):
    def forbidden(*args, **kwargs):
        raise AssertionError("called with the recorder off")

    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", forbidden)
    monkeypatch.delenv("MESHFLOW_TIMINGS", raising=False)
    assert profiling.span("a") is profiling.span("b", "u", "cuda")  # one shared no-op
    stab = MeshFlowStabilizer(config=MeshFlowConfig(**TINY), device="cpu")
    stab._stabilize_frames(torch.from_numpy(frames), 0)
    online = OnlineMeshFlowStabilizer(config=MeshFlowConfig(**TINY), device="cpu")
    for frame in frames[:3]:
        online.process(frame)
    assert profiling.requests() == [] and modes == []
    assert [name for name, _ in stab.last_timer.stages] == [  # one window, one block
        "detect", "motion", "motion", "solver", "warp+crop", "warp+crop", "metrics"]


def test_a_recorded_clip_is_one_request(monkeypatch, frames):
    monkeypatch.setattr(MeshFlowStabilizer, "CHUNK", 4)  # two windows, two blocks
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", pytest.fail)
    stab = MeshFlowStabilizer(config=MeshFlowConfig(**TINY), device="cpu")
    with profiling.recording():
        stab._stabilize_frames(torch.from_numpy(frames), 0)
    (req,) = profiling.requests()
    assert req.root.name == "clip" and req.device is None

    def below(span):
        return [s.name for s in req.spans if s.parent == span.index]

    assert below(req.root) == ["stream.pass1", "stream.pass2"]
    pass1, pass2 = (req.named(name)[0] for name in ("stream.pass1", "stream.pass2"))
    assert below(pass1) == ["detect", "motion"] * 2 + ["motion"]
    assert below(pass2) == ["solver", "warp+crop"] + ["warp+crop", "metrics"] * 2
    scan, *blocks = req.named("warp+crop")
    assert below(scan) == []  # the crop scan: maps and edges, no pixels
    for render in blocks:
        assert below(render) == ["render.maps", "render.warp", "render.crop"]
    assert req.syncs == 0 and all(s.device_ms is None for s in req.spans)


@pytest.mark.parametrize("enable", ["env", "argument"])
def test_timings_record_the_call_and_report_syncs(monkeypatch, frames, capsys, enable):
    """MESHFLOW_TIMINGS=1, or a timer made enabled (the benchmark's
    stage-timed clip), records the call without a profiler."""
    monkeypatch.delenv("MESHFLOW_TIMINGS", raising=False)
    timer = None
    if enable == "env":
        monkeypatch.setenv("MESHFLOW_TIMINGS", "1")
    else:
        timer = StageTimer(enabled=True, device="cpu")
    stab = MeshFlowStabilizer(config=MeshFlowConfig(**TINY), device="cpu")
    stab._stabilize_frames(torch.from_numpy(frames), 0, timer)
    (req,) = profiling.requests()
    assert req.root.name == "clip" and not req.profiled
    table = stab.last_timer.report()
    assert list(table) == ["detect", "motion", "solver", "warp+crop", "metrics"]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and all(line.endswith("syncs 0") for line in lines[:5])
    with profiling.span("later"):  # the switch was for that call only
        pass
    assert len(profiling.requests()) == 1


def test_a_recorded_online_frame_is_one_request(frames):
    online = OnlineMeshFlowStabilizer(config=MeshFlowConfig(**TINY), device="cpu")
    online._runner = StandInRunner()
    with profiling.recording():
        for frame in frames[:5]:
            online.process(frame)
    record = profiling.requests()
    assert [r.root.name for r in record] == ["online.frame"] * 5
    assert _names(record[0]) == ["online.frame", "online.upload"]
    step = ["online.frame", "online.upload", "online.step"]
    assert _names(record[1]) == step + ["graph.warmup:_step", "online.download"]
    assert _names(record[2]) == step + ["graph.capture:_step", "graph.replay:_step",
                                        "online.download"]
    assert _names(record[4]) == step + ["graph.replay:_step", "online.download"]
    assert record[4].spans[3].parent == 2  # the replay inside online.step


def test_runner_records_warmups_captures_and_replays_by_unit():
    runner = StandInRunner()
    x = torch.ones(3)
    before = graphs.totals["captures"], graphs.totals["replays"]
    with profiling.recording(), profiling.span("outer"):
        for _ in range(4):
            runner.run(_affine, (x,), 2.0)
        runner.run(_affine, (x[:2],), 2.0)  # another shape: another warm-up
    (req,) = profiling.requests()
    assert _names(req) == ["outer", "graph.warmup:_affine", "graph.capture:_affine",
                           "graph.replay:_affine", "graph.replay:_affine",
                           "graph.replay:_affine", "graph.warmup:_affine"]
    assert all(s.parent == 0 for s in req.spans[1:])
    assert runner.captures == 1 and runner.replays == 3
    assert (graphs.totals["captures"] - before[0], graphs.totals["replays"] - before[1]) == (1, 3)
    assert "capture_seconds" not in graphs.totals
