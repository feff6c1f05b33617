#!/usr/bin/env python3
"""Readings that set a cell's limits, on the card at the cell's own size.

    python3 portbench/control.py --workload <cell> --program-seeds 1,2,... --control-seeds 7,8,9

For each program seed: the cell's inputs as a run makes them (the clip a
run compares, or the session of warm and window frames), the program's
output through the timed path's entry (``_stabilize_frames`` or
``process``), the reference's, and the gaps.  For each control seed: the
reference one precision below the configuration's (``compare.py``: TF32
matmuls, bfloat16 image arithmetic) put in the program's place, held
against the reference.  With ``--faults``, for each fault seed: the
program with each named fault of ``faults.py`` planted, against the
reference.  One JSON line a reading; the benchmark's own runs never run
this.  A gap's lower reading is its largest over the program seeds, its
upper the smallest over the control seeds, or over a fault's where the
control does not move it (``PERF.md`` gives both).
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def readings(spec, cell_name, program_seeds, control_seeds, device="cuda", root=HERE.parent,
             seconds=None, emit=print, faults=(), fault_seeds=()):
    """Emit one JSON line a reading: {"kind": "program", "control" or
    "fault:<name>", "seed", "gaps", "seconds"}; a fault's reading is the
    program with the fault planted (``faults.py``).  The cell's loop module
    (``loops/<loop>.py``) gives the inputs, both outputs and the gaps."""
    import contextlib

    import torch

    from meshflow_tpu_torch.config import MeshFlowConfig
    from portbench import compare, loops
    from portbench.faults import planted
    from portbench.run import clear_program_environment, find

    seconds = seconds if seconds is not None else spec["run_seconds"]
    cell = find(spec["workloads"], cell_name)
    cfg = json.loads((root / find(spec["configs"], cell["config"])["file"]).read_text())
    traffic = json.loads((root / HERE.name / "traffic" / f"{cell['traffic']}.json").read_text())
    loop = loops.load(root / HERE.name, traffic["loop"])
    config = compare.meshflow_config(MeshFlowConfig, cfg, traffic)
    clear_program_environment()
    kinds = [("program", program_seeds), ("control", control_seeds)]
    kinds += [("fault:" + name, fault_seeds) for name in faults]
    for kind, seeds in kinds:
        for seed in seeds:
            t0 = time.perf_counter()
            data = loop.compared_input(seed, cfg, traffic, seconds)
            ref = loop.reference_output(cfg, traffic, data, device, False)
            if kind == "control":
                out = loop.reference_output(cfg, traffic, data, device, True)
            else:
                fault = kind.split(":")[1] if ":" in kind else None
                with planted(fault) if fault else contextlib.nullcontext():
                    out = loop.program_output(config, cfg, traffic, data, device)
            gaps = loop.gaps(traffic, out, ref)
            del out, ref
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            emit(json.dumps({"cell": cell_name, "kind": kind, "seed": seed, "gaps": gaps,
                             "seconds": time.perf_counter() - t0}))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--program-seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="", help="comma-separated names of faults.FAULTS")
    parser.add_argument("--fault-seeds", default="")
    args = parser.parse_args()
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    readings(spec, args.workload, seeds(args.program_seeds), seeds(args.control_seeds),
             emit=lambda line: print(line, flush=True),
             faults=[f for f in args.faults.split(",") if f], fault_seeds=seeds(args.fault_seeds))


if __name__ == "__main__":
    main()
