"""BENCHMARK.json against the layout and the contract's shapes."""

import ast
import json
import re

from portbench.tests.layout import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(SPEC) == KEYS
    assert SPEC["paths"] == [BENCH.name]
    assert SPEC["command"] == ["python3", f"{BENCH.name}/run.py"]
    assert 1 <= len(SPEC["workloads"]) <= 24 and 1 <= len(SPEC["configs"]) <= 24
    check_s = (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert check_s <= 43200, "a full check of 24 cells at this run length does not fit"


def test_every_cell_and_metric_resolves_to_its_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = set()
    for cell in SPEC["workloads"]:
        conf = configs[cell["config"]]
        used.add(conf["name"])
        assert (ROOT / conf["file"]).is_file() and conf["file"].startswith(BENCH.name + "/")
        assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{cell['name']}.json").is_file()
        assert cell["chips"] in (1, 4)
    assert used == set(configs)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {c["name"] for c in SPEC["workloads"]}
    for metric in SPEC["per_layer"]:
        source = (BENCH / "layer_metrics" / f"{metric['name']}.py").read_text()
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
                   for n in ast.parse(source).body)
        moved = e2e[metric["moves"]]
        for cell in metric["workloads"]:
            assert cell in cells
            assert cell in moved.get("workloads", cells), (metric["name"], cell)


def test_names_units_and_entries_use_the_allowed_forms():
    entries = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    for entry in entries:
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
    for cell in SPEC["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    for conf in SPEC["configs"]:
        assert set(conf) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in conf["reduced"])
    for metric in SPEC["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    for metric in SPEC["per_layer"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for metric in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_roofline_names_and_units():
    for metric in SPEC["per_layer"]:
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%" and metric["better"] == "higher"
