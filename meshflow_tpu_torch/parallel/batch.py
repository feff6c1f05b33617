"""Multi-clip batch parallelism: the port of ``meshflow_tpu/parallel/batch.py``.

Independent clips share nothing, so they fan out whole over devices: a
thread pool with one worker per device, each job taking a device from a
queue and running its own ``MeshFlowStabilizer(device=d, seed=seed)``
with d the thread's current device, as the JAX package sets its default
device per worker.  A device may repeat in the list, so one card can run
several workers.  Each job gives what a solo ``stabilize`` of its clip
gives.

Threads have not sped a batch up on H100s: two workers on one card took
1.9 times the wall of one worker running both clips in turn, and four
workers on four cards 4.5 times.  The host work a clip grows with the
number of workers (the process's CPU time a clip 3.7 and 12.9 times one
worker's) while the card is idle most of the time (in a profiled run,
kernels running 23% of the wall with one worker, 16% with two), so the
workers contend on the host; which lock is not yet traced
(``scripts/torch_multicard.py`` measures it).  Of the layouts measured,
one worker (``devices=[one card]``) runs a batch fastest.

CLI: python -m meshflow_tpu_torch.parallel.batch manifest.json
  manifest: [{"input": ..., "output": ..., "variant": "original"}, ...]
  prints one JSON line of metrics per job, in manifest order.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import queue
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from meshflow_tpu_torch import config as cfg
from meshflow_tpu_torch.config import MeshFlowConfig


@dataclass(frozen=True)
class BatchJob:
    """One clip: input and output are paths, or the objects the stream
    takes (``streaming.ArrayClip`` in, ``streaming.CaptureWriter`` out)."""

    input_path: object
    output_path: object
    adaptive_weights_definition: int = cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL


def stabilize_batch(
    jobs: Sequence[BatchJob],
    config: Optional[MeshFlowConfig] = None,
    devices: Optional[Sequence] = None,
    seed: int = 0,
) -> Tuple[Tuple[float, float, float], ...]:
    """Stabilize independent clips concurrently across `devices` (default:
    every CUDA device); returns each job's (cropping_ratio,
    distortion_score, stability_score) in job order."""
    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.parallel import cuda_devices

    devices = list(cuda_devices() if devices is None else devices)
    num_workers = max(1, min(len(devices), len(jobs)))
    device_pool: "queue.Queue" = queue.Queue()
    for d in devices[:num_workers]:
        device_pool.put(d)

    def run(job: BatchJob):
        device = torch.device(device_pool.get())
        current = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        try:
            with current:
                stabilizer = MeshFlowStabilizer(config=config, seed=seed, device=device)
                return stabilizer.stabilize(
                    job.input_path, job.output_path, job.adaptive_weights_definition
                )
        finally:
            device_pool.put(device)

    if num_workers == 1:
        return tuple(run(job) for job in jobs)
    with concurrent.futures.ThreadPoolExecutor(num_workers) as pool:
        return tuple(pool.map(run, jobs))


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(
        prog="meshflow-torch-batch",
        description="Stabilize a manifest of clips across devices",
    )
    p.add_argument("manifest", help="JSON list of {input, output, variant}")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", default=None,
                   help="comma-separated torch devices, one worker each; a device "
                   "may repeat (default: every CUDA device)")
    args = p.parse_args(argv)

    variants = {
        "original": cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL,
        "flipped": cfg.ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED,
        "constant-high": cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH,
        "constant-low": cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW,
    }
    with open(args.manifest) as f:
        spec = json.load(f)
    jobs = [
        BatchJob(
            input_path=item["input"],
            output_path=item["output"],
            adaptive_weights_definition=variants[item.get("variant", "original")],
        )
        for item in spec
    ]
    devices = args.devices.split(",") if args.devices else None
    results = stabilize_batch(jobs, seed=args.seed, devices=devices)
    for job, (cr, ds, ss) in zip(jobs, results):
        print(
            json.dumps(
                {
                    "input": job.input_path,
                    "output": job.output_path,
                    "cropping_ratio": cr,
                    "distortion_score": ds,
                    "stability_score": ss,
                }
            )
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
