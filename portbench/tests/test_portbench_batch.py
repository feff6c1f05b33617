"""The batch loop (``loops/batch.py``) and its six readers on the CPU.

The readers against hand-made records, and None where the run recorded
nothing (another loop's run, or a program without the workers' records).
A tiny batch cell, added to a temporary copy of the layout as new files
and entries only: a sound traced run is correct and reports the readers
that read the host's clock; a job-order swap in the parent, and the
control in the program's place, are not correct; and a program whose
workers report no reserved peak makes the run exit before any worker
starts."""

import json
import shutil

import pytest
import torch

from meshflow_tpu_torch.parallel import workers
from portbench import compare, control, run
from portbench.run import read_layer_metric
from portbench.tests.layout import BENCH, tiny_layout

SEED = 2**31 + 17
CELL = "sd360-batch-4chip"
READERS = ("batch.worker_start_s", "batch.share_ms_per_frame", "batch.worker_idle_max",
           "batch.captures_per_clip", "stream.pass1_ms_per_frame", "stream.pass2_ms_per_frame")


def span(name, parent, start_ms, end_ms, device_ms=None):
    return {"name": name, "parent": parent, "host_start_ns": int(start_ms * 1e6),
            "host_end_ns": int(end_ms * 1e6), "device_ms": device_ms, "syncs": 0}


def job(start_ms, end_ms, pass1, pass2):
    return {"root": "stabilize", "device": "cuda:0", "profiled": False, "spans": [
        span("stabilize", None, start_ms, end_ms, end_ms - start_ms),
        span("stream.pass1", 0, start_ms, start_ms + 1, pass1),
        span("stream.pass2", 0, start_ms + 1, end_ms, pass2)]}


def batch_ctx():
    """A traced call from 0 to 100 ms: worker 0 held jobs over 10-50 and
    40-90 ms (an overlap: 80 ms held), worker 1 over 0-30 (70 ms idle); 10
    frames a job, 2 clips captured 6 graphs in the window."""
    call = {"root": "batch.call", "device": None, "profiled": False, "spans": [
        span("batch.call", None, 0, 100), span("batch.share_in", 0, 0, 4),
        span("batch.map", 0, 4, 97), span("batch.share_out", 0, 97, 100)]}
    setup = {"root": "batch.pool_start", "device": None, "profiled": False,
             "spans": [span("batch.pool_start", None, 1000, 3500)]}
    return {"loop": "batch", "frames": 10, "call_frames": 30, "setup_requests": [setup],
            "call_requests": [call], "window_captures": 6, "window_clips": 2,
            "worker_requests": [[job(10, 50, 20.0, 30.0), job(40, 90, 40.0, 50.0)],
                                [job(0, 30, 60.0, 70.0)]]}


def read(name, ctx):
    return read_layer_metric(BENCH, name, ctx)


@pytest.mark.parametrize("name", READERS)
def test_none_where_nothing_was_recorded(name):
    assert read(name, {"loop": "closed", "frames": 10, "summary": None}) is None
    empty = dict(batch_ctx(), setup_requests=[], call_requests=[], worker_requests=[],
                 window_clips=0)
    assert read(name, empty) is None


def test_readers_on_a_hand_made_record():
    ctx = batch_ctx()
    assert read("batch.worker_start_s", ctx) == pytest.approx(2.5)
    assert read("batch.share_ms_per_frame", ctx) == pytest.approx(7 / 30)
    assert read("batch.worker_idle_max", ctx) == pytest.approx(70.0)
    assert read("batch.captures_per_clip", ctx) == pytest.approx(3.0)
    # a job's device ms over its 10 frames, the median of 2, 4 and 6
    assert read("stream.pass1_ms_per_frame", ctx) == pytest.approx(4.0)
    assert read("stream.pass2_ms_per_frame", ctx) == pytest.approx(5.0)
    ctx["worker_requests"][1][0]["spans"][1]["device_ms"] = None  # a CPU job
    assert read("stream.pass1_ms_per_frame", ctx) is None


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """The tiny layout plus a two-worker batch cell on the CPU under the
    batch cell's limits."""
    torch.set_num_threads(2)
    root, spec = tiny_layout(tmp_path_factory.mktemp("portbench"), height=96, width=128)
    bench = root / BENCH.name
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    cfg.update(max_features_per_subframe=64, ransac_iterations=64, lk_max_iterations=10,
               optimization_num_iterations=20, cards=2, workers_per_card=1)
    (bench / "configs" / "tiny-host2.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "tiny-host2", "source": "the tests' small config",
                            "file": f"{BENCH.name}/configs/tiny-host2.json", "reduced": [],
                            "why": "a CPU run in seconds"})
    mix = json.loads((bench / "traffic" / "clips_batched_8.json").read_text())
    (bench / "traffic" / "tiny_batched.json").write_text(
        json.dumps(dict(mix, frames=8, distinct_clips=3)))
    shutil.copy(bench / "limits" / f"{CELL}.json", bench / "limits" / "tiny-batch.json")
    spec["workloads"].append({"name": "tiny-batch", "config": "tiny-host2",
                              "traffic": "tiny_batched", "chips": 1, "why": "tests"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].append("tiny-batch")
    yield root, spec
    workers.shutdown()


def execute(layout, trace=False):
    root, spec = layout
    return run.execute(spec, "tiny-batch", SEED, 0.5, trace, device="cpu", root=root)


def test_sound_traced_run_is_correct_and_reports_its_metrics(layout):
    line = execute(layout, trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 3 and line["failed"] == 0
    # the profiled job in the calling process gives the line its trace
    assert 0 <= line["device"]["busy_s"] <= line["device"]["window_s"]
    assert "breakdown" in line
    # the host-clock readers read on the CPU; the stream's device intervals do not
    assert set(line["metrics"]) == {"batch.worker_start_s", "batch.share_ms_per_frame",
                                    "batch.worker_idle_max", "batch.captures_per_clip"}
    assert workers.current() is None  # shut down before the reference ran


def test_swapped_job_order_is_not_correct(layout, monkeypatch):
    def rotated(self, fn, args_list):
        results = original(self, fn, args_list)
        return results[1:] + results[:1]

    original = workers.WorkerPool.map
    monkeypatch.setattr(workers.WorkerPool, "map", rotated)
    line = execute(layout)
    assert not line["correct"], line["checks"]


def test_control_in_the_programs_place_is_not_correct(layout):
    root, spec = layout
    lines = []
    control.readings(spec, "tiny-batch", [], [SEED], device="cpu", root=root, seconds=0.5,
                     emit=lines.append)
    limits = json.loads((root / BENCH.name / "limits" / "tiny-batch.json").read_text())
    gaps = json.loads(lines[0])["gaps"]
    assert not compare.judge(gaps, limits)[0], gaps


def test_a_program_without_the_reserved_peak_exits_before_any_worker(layout, monkeypatch):
    monkeypatch.delattr(workers, "empty_usage")
    with pytest.raises(SystemExit, match="peak_reserved_bytes"):
        execute(layout)
    assert workers.current() is None
