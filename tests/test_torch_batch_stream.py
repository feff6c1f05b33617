"""The multi-clip batch as its deployment runs it: ``stabilize_batch`` over
worker processes, each job through ``MeshFlowStabilizer.stabilize`` and so
the two-pass stream, held against the plain reference of the batch
(``portbench/reference/batch.py``: job k's result is clip k's solo result)
under the limits of the benchmark's batch cell; the spans a traced call
brings back from the parent and the workers; the shared-memory slots the
pool keeps between calls (reused, replaced, dropped, and never the
frames a job's writer owns); the workers' reserved peak on the card; and
a worker that exits before it is ready.

CPU, ``tests/test_torch_parallel.py``'s small geometry and truncated
configuration, one pool of two CPU workers for the file.  Every test that
spawns has a time limit of its own, so that a hung child fails one test.
"""

import contextlib
import json
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from meshflow_tpu_torch import streaming
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.parallel import batch, workers
from meshflow_tpu_torch.utils import profiling
from portbench import clips as bench_clips
from portbench import compare, loops
from portbench.reference import batch as ref_batch
from portbench.reference import config as ref_config
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)

BENCH = Path(__file__).resolve().parents[1] / "portbench"
SMALL = dict(max_features_per_subframe=64, ransac_iterations=64, lk_max_iterations=10,
             optimization_num_iterations=20)
H, W, FRAMES = 96, 128, 8
CPUS = [torch.device("cpu")] * 2
TRAFFIC = {"scores": True, "adaptive_weights_definition": 0}
LIMITS = json.loads((BENCH / "limits" / "sd360-batch-4chip.json").read_text())


@contextlib.contextmanager
def time_limit(seconds):
    """Raise TimeoutError in the test, and end every worker process, when
    the block runs past `seconds`."""
    def expire(signum, frame):
        workers.shutdown(terminate=True)
        raise TimeoutError(f"worker processes still running after {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True, scope="module")
def close_pools():
    """No worker process outlives the module."""
    yield
    workers.shutdown()


def _clips(count, seed=91, frames=FRAMES):
    """`count` distinct seeded clips (the benchmark's generator)."""
    return [bench_clips.synthetic_clip([seed, i], frames, H, W, pan=12) for i in range(count)]


def _call(made, devices=CPUS):
    """One batch call of `made`: each job's (frames, scores) in job order."""
    jobs = [batch.BatchJob(streaming.ArrayClip(c), streaming.CaptureWriter(), 0) for c in made]
    scores = batch.stabilize_batch(jobs, config=MeshFlowConfig(**SMALL), devices=devices)
    return [(job.output_path.frames(), s) for job, s in zip(jobs, scores)]


@pytest.fixture(scope="module")
def three_jobs():
    """A batch of 3 distinct clips on two workers, and each clip's
    reference: (outputs, references)."""
    made = _clips(3)
    with time_limit(180):
        outs = _call(made)
    config = compare.meshflow_config(ref_config.MeshFlowConfig, SMALL, TRAFFIC)
    refs = [(frames, (float(r), float(d), float(s))) for frames, _, r, d, s in
            ref_batch.stabilize_clips([torch.from_numpy(c) for c in made], config, 0)]
    return outs, refs


def _judge(out, ref):
    gaps = loops.load(BENCH, "batch").gaps(TRAFFIC, out, ref)
    return compare.judge(gaps, LIMITS)


def test_batch_jobs_match_their_clips_references(three_jobs):
    outs, refs = three_jobs
    for out, ref in zip(outs, refs):
        correct, checks = _judge(out, ref)
        assert correct, checks


def test_swapped_job_order_fails_the_limits(three_jobs):
    outs, refs = three_jobs
    for k in range(3):
        correct, checks = _judge(outs[(k + 1) % 3], refs[k])
        assert not correct, (k, checks)


def _slot_spans():
    """The slot spans of the one recorded ``batch.call``."""
    (call,) = [r for r in profiling.requests() if r.root.name == "batch.call"]
    return [s.name for s in call.spans if s.name.startswith("batch.slot")]


def _same(outs, others):
    for (frames, scores), (other_frames, other_scores) in zip(outs, others, strict=True):
        assert np.array_equal(frames, other_frames)
        assert scores == other_scores


def test_traced_call_brings_back_workers_and_parent_spans():
    made = _clips(2)
    with time_limit(180):
        _call(made)  # the slots of two such jobs, whatever ran before
    profiling.clear()
    with time_limit(180), profiling.recording():
        _call(made)
    parent = [r for r in profiling.requests() if r.root.name == "batch.call"]
    assert len(parent) == 1
    assert [s.name for s in parent[0].spans] == (
        ["batch.call", "batch.share_in"] + ["batch.slot:kept"] * 4
        + ["batch.map", "batch.share_out"])
    assert [s.parent for s in parent[0].spans[1:]] == [0] + [1] * 4 + [0, 0]
    usage = workers.current().last_usage
    assert [u["tasks"] for u in usage] == [1, 1]
    call = parent[0].root
    for u in usage:
        (job,) = u["requests"]
        names = [s["name"] for s in job["spans"]]
        assert job["root"] == "stabilize" and names[0] == "stabilize"
        assert {"stream.pass1", "stream.pass2"} <= set(names)
        for s in job["spans"]:
            assert call.host_start_ns <= s["host_start_ns"] <= s["host_end_ns"]
            assert s["host_end_ns"] <= call.host_end_ns
        json.dumps(job)
    profiling.clear()
    with time_limit(180):
        _call(made)  # recorder off: the workers record nothing
    assert profiling.requests() == []
    assert all(u["requests"] == [] for u in workers.current().last_usage)


def test_a_second_call_keeps_its_slots_and_gives_the_same_results():
    """A call of the same clips again takes every slot it had: its frames
    and scores equal the first call's and the in-process batch's."""
    made = _clips(2, seed=92)
    with time_limit(240):
        first = _call(made)
        profiling.clear()
        with profiling.recording():
            second = _call(made)
    assert _slot_spans() == ["batch.slot:kept"] * 4
    _same(second, first)
    _same(second, _call(made, devices=CPUS[:1]))  # one entry: no pool, no slot


def test_a_writer_owns_its_frames_after_the_next_call():
    """The next call, of other clips, reuses the slots; the frames the last
    call's writers hold stay as they were: each owns a copy."""
    with time_limit(240):
        jobs = [batch.BatchJob(streaming.ArrayClip(c), streaming.CaptureWriter(), 0)
                for c in _clips(2, seed=93)]
        batch.stabilize_batch(jobs, config=MeshFlowConfig(**SMALL), devices=CPUS)
        before = [job.output_path.frames() for job in jobs]
        others = _call(_clips(2, seed=94))
    for job, frames, (other, _) in zip(jobs, before, others):
        assert not np.array_equal(other, frames)
        assert np.array_equal(job.output_path.frames(), frames)


def test_longer_clips_take_new_slots_and_stay_right():
    """Clips longer than the slots replace them by larger ones; shorter
    clips after them take views of those.  The frames and scores equal the
    in-process batch's."""
    longer, shorter = _clips(2, seed=95, frames=FRAMES + 4), _clips(2, seed=96)
    with time_limit(300):
        _call(_clips(2))
        profiling.clear()
        with profiling.recording():
            outs = _call(longer)
        assert _slot_spans() == ["batch.slot:new"] * 4
        profiling.clear()
        with profiling.recording():
            short_outs = _call(shorter)
        assert _slot_spans() == ["batch.slot:kept"] * 4
        slots = workers.current()._slots
        _same(outs, _call(longer, devices=CPUS[:1]))
        _same(short_outs, _call(shorter, devices=CPUS[:1]))
    assert {name: t.shape[0] for name, t in slots.items()} == {
        f"batch.{side}.{k}": FRAMES + 4 for side in ("in", "out") for k in range(2)}


# Run in a worker: the names of the slots it holds.
CHILD_HELD = "sorted(__import__('meshflow_tpu_torch.parallel.workers').parallel.workers._HELD)"


def test_a_call_with_fewer_jobs_leaves_only_its_slots():
    """After three jobs, a call of two leaves the pool, and every worker,
    holding only that call's slots."""
    with time_limit(240):
        _call(_clips(3))
        pool = workers.current()
        assert len(pool._slots) == 6
        assert sorted(n for held in pool.each(eval, [(CHILD_HELD,)] * 2) for n in held) == \
            sorted(pool._slots)
        _call(_clips(2))
        held = pool.each(eval, [(CHILD_HELD,)] * 2)
    names = {f"batch.{side}.{k}" for side in ("in", "out") for k in range(2)}
    assert set(pool._slots) == names
    assert set().union(*held) <= names


def test_a_slot_writer_never_writes_past_its_slot():
    slot = np.zeros((4, 2, 3, 3), np.uint8)
    writer = batch._SlotWriter(slot)
    writer.write(np.full((3, 2, 3, 3), 7, np.uint8))
    with pytest.raises(ValueError, match="does not fit"):
        writer.write(np.ones((2, 2, 3, 3), np.uint8))
    with pytest.raises(ValueError, match="does not fit"):
        writer.write(np.ones((1, 3, 2, 3), np.uint8))
    writer.write(np.full((1, 2, 3, 3), 9, np.uint8))
    assert writer.count == 4
    assert (slot[:3] == 7).all() and (slot[3] == 9).all()


@pytest.mark.cuda
def test_workers_report_their_reserved_peak_on_cards():
    """On two cards each worker reports its reserved peak, at least its
    allocated one (a CUDA graph's pool sits in reserved memory)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices: a batch worker a card")
    with time_limit(600):
        _call(_clips(2), devices=["cuda:0", "cuda:1"])
        usage = workers.current().last_usage
        workers.shutdown()
    for u in usage:
        assert u["peak_bytes"] > 0
        assert u["peak_reserved_bytes"] >= u["peak_bytes"]


@pytest.mark.cuda
def test_an_idle_worker_keeps_no_more_device_memory_after_more_jobs():
    """Two workers on one card, two calls: what a worker holds between
    tasks does not grow with the jobs it ran (each job's graph runner
    warms up on a stream of its own, where cuBLAS keeps a workspace)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a batch worker on the card")
    devices = ["cuda:0", "cuda:0"]
    held = []
    with time_limit(600):
        for _ in range(2):
            _call(_clips(2), devices=devices)
            pool = workers.pool(devices)
            held.append(pool.each(torch.cuda.memory_allocated, [()] * 2))
        workers.shutdown()
    assert held[1] == held[0], held


def test_a_child_that_exits_before_it_is_ready_fails_the_start(tmp_path, monkeypatch):
    """A worker whose import of the port fails (here: a package of the
    same name ahead on the children's path) exits before its ready
    message: the pool's start raises instead of waiting, and no child is
    left."""
    fake = tmp_path / "meshflow_tpu_torch"
    fake.mkdir()
    (fake / "__init__.py").write_text("raise ImportError('a broken install')\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    workers.shutdown()
    with time_limit(120):
        with pytest.raises(workers.WorkerError, match="before it was ready"):
            workers.pool(CPUS)
    assert workers.current() is None
