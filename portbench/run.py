#!/usr/bin/env python3
"""The benchmark of meshflow_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port.  The cell names a configuration file and a traffic file,
whose ``"loop"`` names the loop module (``loops/<loop>.py``) that drives
it; set-up makes the clips from the seed, builds or loads the kernel library
(``build/meshflow_tpu_torch/<hash>/`` in the checkout) and warms up the
cell's shapes, graph captures included; the window then runs for
``--seconds``.  Afterwards the program's state is freed and the plain
reference (``reference/``) recomputes a sample of the outputs, drawn from
the seed, for ``correct``.  ``--trace 0`` reports the cell's end-to-end
metrics; ``--trace 1`` also runs the stage-timed and the profiled clip (or
the traffic's ``trace_frames`` online frames) after the window and
reports its per-layer metrics, each read by ``layer_metrics/<name>.py``.
The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error.  Without a CUDA
card the run fails.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

FORBIDDEN = ("jax", "jaxlib", "flax", "meshflow_tpu")


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def find(entries, name: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise SystemExit(f"portbench: no entry named {name!r}")


def cell_metrics(spec: dict, cell: str, kind: str):
    """The `kind` ("end_to_end" or "per_layer") metrics the cell reports:
    those that list it, and those without a list whose end-to-end metric
    the cell reports."""
    e2e = {m["name"] for m in spec["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
    if kind == "end_to_end":
        return [m for m in spec["end_to_end"] if m["name"] in e2e]
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]


def read_layer_metric(bench: Path, name: str, ctx: dict):
    """``layer_metrics/<name>.py``'s ``read(ctx)`` under `bench`: a number,
    or None when the run has nothing for it to read."""
    path = bench / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def clear_program_environment():
    """Unset every ``MESHFLOW_*`` variable, so that the program runs its
    defaults (graphed batches, kernel A) as users get them."""
    for key in [k for k in os.environ if k.startswith("MESHFLOW_")]:
        del os.environ[key]


def execute(spec: dict, cell_name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", root: Path = HERE.parent, t0: float = _T0) -> dict:
    """One run of the cell on `device`; returns the result line's object."""
    import torch

    from meshflow_tpu_torch.config import MeshFlowConfig
    from portbench import compare, loops
    from portbench import trace as tracing

    bench = root / HERE.name
    log(f"imports done at {time.perf_counter() - t0:.3f} s")
    cell = find(spec["workloads"], cell_name)
    conf = find(spec["configs"], cell["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{cell_name}.json").read_text())
    clear_program_environment()
    loop = loops.load(bench, traffic["loop"])
    job = loops.Job(seed=seed, seconds=seconds, trace=trace, cfg=cfg, traffic=traffic,
                    config=compare.meshflow_config(MeshFlowConfig, cfg, traffic),
                    device=torch.device(device), t0=t0)
    result = loop.run(job)
    ctx = dict(result.ctx, loop=traffic["loop"], height=cfg["height"], width=cfg["width"],
               vertices=job.config.vertex_rows * job.config.vertex_cols,
               summary=result.summary)
    e2e = dict(result.e2e, setup_s=result.setup_s, peak_mem_gib=result.peak_bytes / 2**30)

    correct, checks = compare.judge(result.gaps, limits)
    if trace:
        wanted = cell_metrics(spec, cell_name, "per_layer")
        values = {m["name"]: read_layer_metric(bench, m["name"], ctx) for m in wanted}
    else:
        wanted = cell_metrics(spec, cell_name, "end_to_end")
        values = {m["name"]: e2e.get(m["name"]) for m in wanted}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values[m["name"]] is not None}
    device_info = {
        "platform": "gpu" if job.on_card else job.device.type,
        "kind": torch.cuda.get_device_name(job.device) if job.on_card else job.device.type,
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(result.peak_bytes),
    }
    line = {"correct": correct, "attempted": result.attempted, "failed": result.failed,
            "metrics": metrics, "device": device_info}
    if result.summary is not None:
        device_info["busy_s"] = result.summary["busy_s"]
        device_info["window_s"] = result.summary["window_s"]
        line["breakdown"] = tracing.breakdown(result.summary)
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    chips = int(find(spec["workloads"], args.workload)["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: the cell needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    from portbench import roofline

    log(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: {roofline.power_limit()}")
    line = execute(spec, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        log(f"portbench: the process loaded {', '.join(found)}; no result")
        return 3
    for name, check in line["checks"].items():
        log(f"check {name} {check['value']!r} limit {check['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
