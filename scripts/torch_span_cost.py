#!/usr/bin/env python3
"""What the port's span recorder (``meshflow_tpu_torch/utils/profiling.py``)
costs when it is on, and what it records, on one CUDA card.

    python3 scripts/torch_span_cost.py [--online-frames 1000] [--clips 3]

One process, 640x360 by default, the default config:

* online: one ``OnlineMeshFlowStabilizer`` warmed for 10 frames, then
  ``--online-frames`` frames with the recorder on and as many with it off,
  alternating frame by frame; each ``process`` call timed by the host
  clock (the frame comes back to the host, so the call ends synced);
* clips: one ``MeshFlowStabilizer`` warmed by one clip, then
  ``--clips`` pairs of warm clips, off and on in turns (on, off, off, on,
  ...), each ``_stabilize_frames`` call plus its copy back by the host
  clock (``--frames`` a clip);
* the record of the last recorded clip and online frames: per span name,
  host ms, device ms (CUDA events) and host syncs.

Prints one JSON object (also to ``--out`` when given).
``--device cpu`` with a small ``--size`` rehearses it (no device times).
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from meshflow_tpu_torch.api import MeshFlowStabilizer  # noqa: E402
from meshflow_tpu_torch.config import MeshFlowConfig  # noqa: E402
from meshflow_tpu_torch.online import OnlineMeshFlowStabilizer  # noqa: E402
from meshflow_tpu_torch.utils import profiling  # noqa: E402
from portbench.clips import synthetic_clip  # noqa: E402


def quartiles(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return {"p25": q1, "p50": q2, "p75": q3, "n": len(values)}


def by_name(requests) -> dict:
    """Per span name: calls, host ms, device ms and syncs summed over
    `requests`, divided by their count."""
    sums = collections.defaultdict(lambda: [0, 0.0, 0.0, 0])
    for req in requests:
        for s in req.spans:
            row = sums[s.name]
            row[0] += 1
            row[1] += s.host_ms
            row[2] += s.device_ms or 0.0
            row[3] += s.syncs
    n = max(len(requests), 1)
    return {name: {"calls": c / n, "host_ms": h / n, "device_ms": d / n, "syncs": y / n}
            for name, (c, h, d, y) in sums.items()}


def card(device) -> str:
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"{torch.cuda.get_device_name(device)}; nvidia-smi: {err}"


def online_cost(device, config, h, w, count: int) -> dict:
    frames = synthetic_clip([17, 0], 64, h, w, pan=0.0)
    stab = OnlineMeshFlowStabilizer(config=config, device=device)
    for i in range(10):
        stab.process(frames[i % 64])
    times = {True: [], False: []}
    profiling.clear()
    for i in range(2 * count):
        on = i % 2 == 0
        with profiling.recording(on):
            t0 = time.perf_counter()
            stab.process(frames[(10 + i) % 64])
            times[on].append((time.perf_counter() - t0) * 1e3)
    record = profiling.requests()[-100:]
    stab.close()
    return {"process_ms_on": quartiles(times[True]), "process_ms_off": quartiles(times[False]),
            "spans": by_name(record), "syncs_per_frame": statistics.mean(r.syncs for r in record)}


def clip_cost(device, config, h, w, pairs: int, length: int) -> dict:
    clip = torch.from_numpy(synthetic_clip([17, 1], length, h, w, pan=3 / 16 * w))
    stab = MeshFlowStabilizer(config=config, device=device)

    def run():
        t0 = time.perf_counter()
        cropped, *scores = stab._stabilize_frames(clip.to(device), 0)
        cropped.cpu()
        [float(s) for s in scores]
        return time.perf_counter() - t0

    run()
    walls = {True: [], False: []}
    profiling.clear()
    for i in range(2 * pairs):
        on = (i % 4) in (0, 3)
        with profiling.recording(on):
            walls[on].append(run())
    record = [r for r in profiling.requests() if r.root.name == "clip"][-1:]
    stab.close()
    clip_spans = by_name(record)
    return {"clip_s_on": walls[True], "clip_s_off": walls[False], "spans": clip_spans,
            "syncs_per_frame": record[0].syncs / clip.shape[0] if record else None}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--size", default="360x640", help="HxW")
    parser.add_argument("--online-frames", type=int, default=1000)
    parser.add_argument("--clips", type=int, default=3)
    parser.add_argument("--frames", type=int, default=300, help="frames a clip")
    parser.add_argument("--out", help="a file to write the JSON object to as well")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_span_cost: no CUDA card", file=sys.stderr)
        return 2
    h, w = (int(v) for v in args.size.split("x"))
    config = MeshFlowConfig()
    out = {"card": card(device), "torch": torch.__version__, "size": [h, w],
           "online": online_cost(device, config, h, w, args.online_frames),
           "clip": clip_cost(device, config, h, w, args.clips, args.frames)}
    text = json.dumps(out)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
