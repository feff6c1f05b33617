"""A short run of each cell on the card (skips without one)."""

import json
import subprocess
import sys

import pytest

from portbench.tests.layout import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in SPEC["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the card")
    out = subprocess.run(
        [sys.executable, f"{BENCH.name}/run.py", "--workload", cell, "--seed", "3999999999",
         "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and "setup_s" in line["metrics"]
