"""Whole runs at a small size on the CPU, the look for a card skipped: a
sound run comes out correct, a run whose timed path is broken underneath
does not, nor does the control put in the program's place.  The cells,
config and mixes are added to a temporary copy of the layout as new files
and entries only, which is how a later change adds them."""

import json

import pytest
import torch

from portbench import compare, control, run
from portbench.faults import FAULTS, planted
from portbench.tests.layout import tiny_layout

SEED = 2**31 + 17


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny_layout(tmp_path_factory.mktemp("portbench"))


def execute(layout, cell, trace=False):
    root, spec = layout
    return run.execute(spec, cell, SEED, 0.5, trace, device="cpu", root=root)


@pytest.mark.parametrize("cell", ["tiny-eval", "tiny-online"])
def test_sound_run_is_correct_and_reports_its_metrics(layout, cell):
    line = execute(layout, cell, trace=True)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    names = set(line["metrics"])
    if cell == "tiny-eval":
        # the stage spans and the transfer are read on the CPU too; the
        # device metrics have nothing to read there and are left out
        assert {"motion_ms_per_frame", "metrics_ms_per_frame", "transfer_ms_per_frame"} <= names
        assert "lk_roofline" not in names
    else:
        assert "online.step_ms_p50" in names
    assert list(line)[-1] == "checks"
    json.dumps(line)


def test_added_metric_config_and_mix_need_only_new_files(layout):
    root, spec = layout
    bench = root / "portbench"
    (bench / "layer_metrics" / "frames_per_clip.py").write_text(
        "def read(ctx):\n    return ctx.get('frames')\n")
    spec = dict(spec, per_layer=spec["per_layer"] + [{
        "name": "frames_per_clip", "unit": "frames", "better": "higher", "source": "host_clock",
        "layer": "api", "moves": "clip_fps", "workloads": ["tiny-serve"]}])
    line = run.execute(spec, "tiny-serve", SEED, 0.5, True, device="cpu", root=root)
    assert line["correct"], line["checks"]
    assert line["metrics"]["frames_per_clip"]["value"] == 10
    assert "metrics_ms_per_frame" not in line["metrics"]  # serving skips the metric pass


# A loop kind a later change would add as a file: each distinct clip once.
EACH_ONCE = '''
import time

from portbench.loops import Result, closed

program_output, reference_output, gaps = closed.program_output, closed.reference_output, closed.gaps


def compared_input(seed, cfg, traffic, seconds):
    return closed.clips(seed, cfg, traffic)[0]


def run(job):
    made = closed.clips(job.seed, job.cfg, job.traffic)
    runner = closed.ClipRunner(job.config, job.traffic, job.device)
    setup_s = job.elapsed()
    start = time.perf_counter()
    outs = [runner.run(clip) for clip in made]
    window_s = time.perf_counter() - start
    runner.close()
    ref = reference_output(job.cfg, job.traffic, made[0], job.device)
    return Result(setup_s=setup_s, e2e={"clip_fps": len(made) * job.traffic["frames"] / window_s},
                  attempted=len(made), failed=0, peak_bytes=job.peak_bytes(),
                  gaps=gaps(job.traffic, outs[0], ref), ctx={"frames": job.traffic["frames"]})
'''


def test_added_loop_kind_needs_only_new_files(layout):
    root, spec = layout
    bench = root / "portbench"
    (bench / "loops" / "each_once.py").write_text(EACH_ONCE)
    mix = json.loads((bench / "traffic" / "tiny_closed.json").read_text())
    (bench / "traffic" / "tiny_each_once.json").write_text(json.dumps(dict(mix, loop="each_once")))
    (bench / "limits" / "tiny-once.json").write_text(
        (bench / "limits" / "tiny-eval.json").read_text())
    spec = json.loads(json.dumps(spec))
    spec["workloads"].append({"name": "tiny-once", "config": "tiny",
                              "traffic": "tiny_each_once", "chips": 1, "why": "tests"})
    for metric in spec["end_to_end"]:
        if "tiny-eval" in metric.get("workloads", []):
            metric["workloads"].append("tiny-once")
    line = run.execute(spec, "tiny-once", SEED, 0.5, False, device="cpu", root=root)
    assert line["correct"], line["checks"]
    assert line["attempted"] == 2 and {"clip_fps", "setup_s"} <= set(line["metrics"])
    with planted("answer-altered"):
        line = run.execute(spec, "tiny-once", SEED, 0.5, False, device="cpu", root=root)
    assert not line["correct"], line["checks"]
    lines = []
    control.readings(spec, "tiny-once", [], [SEED], device="cpu", root=root, seconds=0.5,
                     emit=lines.append)
    assert not compare.judge(json.loads(lines[0])["gaps"],
                             json.loads((bench / "limits" / "tiny-once.json").read_text()))[0]


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(layout, name):
    cell = "tiny-eval" if FAULTS[name][3] == "closed" else "tiny-online"
    with planted(name):
        line = execute(layout, cell)
    assert not line["correct"], (name, line["checks"])


@pytest.mark.parametrize("cell", ["tiny-eval", "tiny-online"])
def test_control_in_the_programs_place_is_not_correct(layout, cell):
    root, spec = layout
    lines = []
    control.readings(spec, cell, [], [SEED], device="cpu", root=root, seconds=0.5,
                     emit=lines.append)
    gaps = json.loads(lines[0])["gaps"]
    limits = json.loads((root / "portbench" / "limits" / f"{cell}.json").read_text())
    assert not compare.judge(gaps, limits)[0], gaps
