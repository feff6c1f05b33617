"""A temporary copy of the benchmark's layout with tiny cells added as a
later change would add them: new files and new entries only."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# The port's default config cut to what the CPU runs in seconds: an 8x8
# mesh, 2x2 outlier subframes, 128 features a subframe.
TINY = {"height": 144, "width": 256, "mesh_row_count": 8, "mesh_col_count": 8,
        "mesh_outlier_subframe_row_count": 2, "mesh_outlier_subframe_col_count": 2,
        "max_features_per_subframe": 128, "track_downscale": 0, "track_planes": "bgr"}


def tiny_layout(tmp: Path, frames: int = 10, height: int = 144, width: int = 256):
    """Copy BENCHMARK.json and portbench/ under `tmp` and add the config
    ``tiny``, the mixes ``tiny_closed`` and ``tiny_open`` (small versions of
    the sd360 cells' mixes) and the cells ``tiny-eval``, ``tiny-serve`` and
    ``tiny-online`` under the limits of sd360-eval, sd360-serve and
    sd360-online.  Returns (root, spec)."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = root / BENCH.name
    (bench / "configs" / "tiny.json").write_text(
        json.dumps(dict(TINY, height=height, width=width)))
    spec["configs"].append({"name": "tiny", "source": "the tests' small config",
                            "file": f"{BENCH.name}/configs/tiny.json", "reduced": [],
                            "why": "a CPU run in seconds"})
    closed = json.loads((bench / "traffic" / "clips_scored_4.json").read_text())
    closed.update(frames=frames, distinct_clips=2)
    (bench / "traffic" / "tiny_closed.json").write_text(json.dumps(closed))
    (bench / "traffic" / "tiny_served.json").write_text(json.dumps(dict(closed, scores=False)))
    live = json.loads((bench / "traffic" / "live_30fps.json").read_text())
    live.update(fps=4, warm_frames=3, trace_frames=4)
    (bench / "traffic" / "tiny_open.json").write_text(json.dumps(live))
    for cell, traffic, like in (("tiny-eval", "tiny_closed", "sd360-eval"),
                                ("tiny-serve", "tiny_served", "sd360-serve"),
                                ("tiny-online", "tiny_open", "sd360-online")):
        spec["workloads"].append({"name": cell, "config": "tiny", "traffic": traffic,
                                  "chips": 1, "why": "tests"})
        shutil.copy(bench / "limits" / f"{like}.json", bench / "limits" / f"{cell}.json")
        for metric in spec["end_to_end"] + spec["per_layer"]:
            if like in metric.get("workloads", []):
                metric["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, spec
