"""PyTorch port: the one clip pipeline (``api.MeshFlowStabilizer``'s
``_pass1`` and ``_pass2``) under its two drivers, and the stage timer.

* Each fault the benchmark plants in the closed loop's timed path
  (``portbench/faults.py``: ``api.crop_frames``, ``api.jacobi_smooth``,
  the motion batch and the metric batch, patched by module and name)
  changes ``_stabilize_frames``' frames or scores: the pipeline calls the
  names the fault table patches.
* ``_stabilize_frames`` (a clip on the device) and ``stabilize`` over an
  ``ArrayClip`` into a ``CaptureWriter`` (a clip on the host) run the same
  pass 1 and pass 2, with equal outputs; pass 2 makes each block's
  backward maps but no crop edges (the crop scan makes those).
* ``StageTimer.report`` sums a stage's runs and the seconds other threads
  add.

Small shapes: the TINY config, 10 frames of 72x128: a motion batch of 9
pairs and a metric batch of 10 frames, more than the 8 rows of the first
half that the half-batch faults keep.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from meshflow_tpu_torch import api, streaming
from meshflow_tpu_torch.api import MeshFlowStabilizer
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.render import stabilize as render
from meshflow_tpu_torch.utils import profiling
from meshflow_tpu_torch.utils.profiling import StageTimer
from portbench.faults import FAULTS, planted
from test_torch_slice import TINY, _clip
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)

NUM_FRAMES, H, W = 10, 72, 128
CLOSED_FAULTS = [name for name, (*_, loop) in FAULTS.items() if loop == "closed"]


def _stabilizer():
    return MeshFlowStabilizer(config=MeshFlowConfig(**TINY), device="cpu")


def _in_memory(frames):
    out, *scores = _stabilizer()._stabilize_frames(torch.from_numpy(frames), 0)
    return out, [float(s) for s in scores]


@pytest.fixture(scope="module")
def clip():
    """The clip and its (frames, scores) through ``_stabilize_frames``."""
    frames = _clip(NUM_FRAMES, H, W, pan=24)
    return frames, _in_memory(frames)


@pytest.mark.parametrize("fault", CLOSED_FAULTS)
def test_a_planted_fault_changes_the_clip(clip, fault):
    frames, (want, want_scores) = clip
    with planted(fault):
        got, scores = _in_memory(frames)
    assert not torch.equal(got, want) or scores != want_scores, fault


def test_both_drivers_run_one_pipeline(clip, monkeypatch):
    """CHUNK 4, three blocks: each driver's pass 1 and pass 2 are the
    pipeline's, and each makes three crop edges (the crop scan) and six
    backward maps (the scan, then pass 2)."""
    frames, _ = clip
    calls, counts = [], {"crop_edges": 0, "stabilized_maps": 0}
    for name in ("_pass1", "_pass2"):
        def spy(self, source, *args, _name=name, _original=getattr(MeshFlowStabilizer, name)):
            calls.append((_name, type(source).__name__))
            return _original(self, source, *args)

        monkeypatch.setattr(MeshFlowStabilizer, name, spy)
    for name in counts:
        def counted(*args, _name=name, _original=getattr(render, name)):
            counts[_name] += 1
            return _original(*args)

        monkeypatch.setattr(render, name, counted)
    monkeypatch.setattr(api, "stabilized_maps", render.stabilized_maps)
    monkeypatch.setattr(MeshFlowStabilizer, "CHUNK", 4)
    monkeypatch.delenv("MESHFLOW_STREAM", raising=False)
    got, scores = _in_memory(frames)
    assert counts == {"crop_edges": 3, "stabilized_maps": 6}
    writer = streaming.CaptureWriter()
    streamed = _stabilizer().stabilize(streaming.ArrayClip(frames), writer, 0)
    assert counts == {"crop_edges": 6, "stabilized_maps": 12}
    assert calls == [("_pass1", "DeviceFrames"), ("_pass2", "DeviceFrames"),
                     ("_pass1", "HostFrames"), ("_pass2", "HostFrames")]
    np.testing.assert_array_equal(writer.frames(), got.numpy())
    assert list(streamed) == scores


def test_stage_timer_sums_runs_and_a_threads_add(capsys):
    timer = StageTimer(enabled=True, device="cpu")
    with profiling.recording():  # the stages' spans give the syncs column
        for _ in range(2):
            with timer.stage("motion"):
                pass
    thread = threading.Thread(target=timer.add, args=("decode", 0.25))
    thread.start()
    thread.join(timeout=10)
    assert not thread.is_alive()
    timer.add("decode", 0.5)
    table = timer.report()
    assert list(table) == ["motion", "decode"]
    assert table["decode"] == 0.75
    assert table["motion"] == sum(s for name, s in timer.stages if name == "motion")
    assert len(timer.stages) == 4
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3 and lines[0].endswith("syncs 0") and "decode" in lines[1]


def test_stage_timer_adds_from_many_threads():
    """More threads than cores, switching often: every add is kept."""
    timer, threads, adds = StageTimer(enabled=False), 16, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [timer.add("encode", 1.0)
                                                    for _ in range(adds)])
                   for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in workers)
    finally:
        sys.setswitchinterval(interval)
    assert timer.report() == {"encode": threads * adds}
