"""The yardstick's own arithmetic: clips, bounds, the trace reduction and
the judgement of gaps."""

import numpy as np
import pytest

from portbench import clips, compare, roofline, trace


def test_clips_are_fixed_by_the_seed_and_differ_across_seeds():
    a = clips.synthetic_clip([2**33 + 7, 0], 6, 48, 64, pan=12)
    b = clips.synthetic_clip([2**33 + 7, 0], 6, 48, 64, pan=12)
    c = clips.synthetic_clip([2**33 + 8, 0], 6, 48, 64, pan=12)
    assert a.shape == (6, 48, 64, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a[0], a[-1])


def test_bounds_on_hand_worked_shapes():
    assert roofline.bound_s(67e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    # one slot set up at 3 channels: 3 * (18 * 22^2 + 33 * 21^2) operations
    assert roofline.lk_level_ops(3, 1, 0) == 3 * (18 * 484 + 33 * 441) == 69795
    # two steps at 1 channel: 2 * 441 * 14
    assert roofline.lk_level_ops(1, 0, 2) == 12348
    level = {"channels": 1, "setups": 0, "steps": 2, "plane_bytes": 1000, "slots": 10}
    assert roofline.lk_bound_s([level, level]) == pytest.approx(
        2 * max(12348 / 67e12, (1000 + 10 * 27) / 3.35e12))
    # one 360x640 frame's maps on the 16x16 mesh in one launch
    assert roofline.bmap_bound_s(1, 1, 289, 360, 640) == pytest.approx(
        (289 * 8 + 9 * 360 * 640 + 289 * 8) / 3.35e12)


class Ev:
    def __init__(self, name, kind, start, dur, tid=1, device="CPU"):
        self._v = (name, kind, start, dur, tid, device)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def device_type(self):
        return "DeviceType." + self._v[5]


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {
            "events": staticmethod(lambda: events)})()})()


def test_trace_reduction_on_a_hand_made_timeline():
    s = 1_000_000_000  # ns
    events = [
        Ev("portbench.window", "user_annotation", 0, 10 * s),
        Ev("stage:motion", "user_annotation", 0, 6 * s),
        Ev("aten::nonzero", "cpu_op", 1 * s, 2 * s),
        Ev("cudaLaunchKernel", "cuda_runtime", 1 * s, 1000),
        Ev("cudaGraphLaunch", "cuda_runtime", 2 * s, 1000),
        Ev("void (anonymous namespace)::map_kernel<3>(float*)", "kernel", 0, 1 * s, 7, "CUDA"),
        Ev("lk_level_kernel(LevelArgs)", "kernel", 3 * s, 2 * s, 7, "CUDA"),
        Ev("lk_level_kernel(LevelArgs)", "kernel", 4 * s, 2 * s, 7, "CUDA"),
        Ev("stage:motion", "gpu_user_annotation", 0, 9 * s, 7, "CUDA"),
        Ev("other thread", "cpu_op", 0, 10 * s, 2),
    ]
    summary = trace.summarize(Prof(events))
    assert summary["window_s"] == pytest.approx(10.0)
    assert summary["busy_s"] == pytest.approx(4.0)  # [0,1] and [3,6]
    assert summary["launches"] == 1 and summary["graph_launches"] == 1
    assert trace.kernel_seconds(summary, ("lk_level_kernel",)) == pytest.approx(4.0)
    assert trace.kernel_count(summary, ("map_kernel",)) == 1
    # idle [1,3] (host in aten::nonzero, then in the motion stage) and [6,10]
    assert summary["idle_gaps"]["motion | aten::nonzero"] == pytest.approx(2.0)
    assert summary["idle_gaps"]["- | host"] == pytest.approx(4.0)
    top = trace.breakdown(summary)
    assert top["device_ops"][0] == ["lk_level_kernel(LevelArgs)", pytest.approx(4.0)]


def test_judge_needs_every_gap_within_its_limit():
    ok, checks = compare.judge({"frame_rms": 0.1, "crop_px": 0.0}, {"frame_rms": 0.2, "crop_px": 0})
    assert ok and checks["frame_rms"] == {"value": 0.1, "limit": 0.2}
    assert not compare.judge({"frame_rms": 0.3}, {"frame_rms": 0.2})[0]
    assert not compare.judge({"frame_rms": float("nan")}, {"frame_rms": 0.2})[0]
    assert not compare.judge({}, {"frame_rms": 0.2})[0]
    assert not compare.judge({"frame_rms": 0.1, "extra": 0.0}, {"frame_rms": 0.2})[0]
