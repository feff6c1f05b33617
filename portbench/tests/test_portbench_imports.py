"""What the harness may load, and how a run without a card ends."""

import ast
import os
import shutil
import subprocess
import sys

from portbench.tests.layout import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "meshflow_tpu", "chip_smoke", "scripts"}


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def harness_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_harness_imports_no_jax_package_by_whole_name():
    for path in harness_files():
        found = imported_top_names(path) & BANNED
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        found = imported_top_names(path) & (BANNED | {"meshflow_tpu_torch"})
        assert not found, f"{path} imports {found}"


def test_run_loads_no_jax_module():
    """The harness's modules, imported in a fresh process, load neither JAX
    nor the JAX package (whole top-level names: the port's name starts
    with the JAX package's)."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import portbench.run as r, portbench.compare, portbench.control;"
            "import portbench.loops.closed, portbench.loops.open;"
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def run_command(cwd, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, f"{BENCH.name}/run.py", "--workload", "sd360-online", "--seed",
         "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=timeout, env=env)


def test_run_without_a_card_fails_and_prints_no_result():
    out = run_command(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = run_command(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
