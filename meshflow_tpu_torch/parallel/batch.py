"""Multi-clip batch parallelism: the port of ``meshflow_tpu/parallel/batch.py``.

Independent clips share nothing, so they fan out whole over devices: one
worker process a device entry (``workers.pool``; an entry may repeat, so
one card can run several workers), each job taken by whichever worker is
free and run as its own ``MeshFlowStabilizer(config, seed=seed,
device=the worker's device)``, as the JAX package pins a device per
worker.  Each job gives what a solo ``stabilize`` of its clip gives, and
the results come back in job order.  One worker runs in the calling
process.

A job's input and output are paths, which travel as they are, or the
objects the stream takes.  With worker processes a job's frames live in
slots that the pool keeps between calls (``WorkerPool.slots``): job k's
``streaming.ArrayClip`` is copied into input slot k, and the worker
reads it there; where the job also writes to a ``streaming.CaptureWriter``,
the worker writes each block of the stream straight into output slot k,
of the clip's shape, and the caller copies the frames written from there
into the job's writer, which owns that copy (the next call reuses the
slot).  A slot is kept while a call's clip k has its frame size and no
more frames, and replaced by a larger one otherwise; the slots of the
last call are all the shared memory held between calls.  A
``CaptureWriter`` after a path input gets its frames through the pipe.
The configuration and ``MeshFlowStabilizer.CHUNK`` are the caller's,
passed to the worker.

A call is the span recorder's request ``batch.call``; with worker
processes it holds ``batch.share_in`` (the slots taken, each a span
``batch.slot:kept`` or ``batch.slot:new``, and the clips copied into
them), ``batch.map`` (the jobs on the workers, each recorded in its
worker as a ``stabilize`` request while the recorder is on, returned in
``workers.current().last_usage``) and ``batch.share_out`` (the frames
written to the jobs' writers).

CLI: python -m meshflow_tpu_torch.parallel.batch manifest.json
  manifest: [{"input": ..., "output": ..., "variant": "original"}, ...]
  prints one JSON line of metrics per job, in manifest order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from meshflow_tpu_torch import config as cfg
from meshflow_tpu_torch import streaming
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.parallel import device_list, workers
from meshflow_tpu_torch.utils import profiling


@dataclass(frozen=True)
class BatchJob:
    """One clip: input and output are paths, or the objects the stream
    takes (``streaming.ArrayClip`` in, ``streaming.CaptureWriter`` out)."""

    input_path: object
    output_path: object
    adaptive_weights_definition: int = cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL


def _run(job: BatchJob, config, seed, device, chunk):
    from meshflow_tpu_torch.api import MeshFlowStabilizer

    current = torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
    with current:
        stabilizer = MeshFlowStabilizer(config=config, seed=seed, device=device)
        stabilizer.CHUNK = chunk
        try:
            return stabilizer.stabilize(job.input_path, job.output_path,
                                        job.adaptive_weights_definition)
        finally:
            stabilizer.close()


class _SlotWriter:
    """The stream's writer in a worker: each block copied into the job's
    output slot at a running frame position."""

    def __init__(self, slot: np.ndarray):
        self.slot, self.count = slot, 0

    def write(self, frames: np.ndarray) -> None:
        end = self.count + len(frames)
        if frames.shape[1:] != self.slot.shape[1:] or end > len(self.slot):
            raise ValueError(f"a block of {frames.shape} at frame {self.count} does not fit "
                             f"the output slot of {self.slot.shape}")
        np.copyto(self.slot[self.count : end], frames)
        self.count = end

    def close(self) -> None:
        pass


def _share_in(pool: workers.WorkerPool, jobs) -> tuple:
    """(each job as a worker takes it, the call's slots by name): an
    ArrayClip as (its input slot's name and view, fps, path), copied there
    by numpy on one thread (a torch copy would run on the caller's
    intra-op threads); a CaptureWriter as its output slot's name and view
    after an ArrayClip, else None (captured in the worker)."""
    shapes = {}
    for k, job in enumerate(jobs):
        if isinstance(job.input_path, streaming.ArrayClip):
            shapes[f"batch.in.{k}"] = job.input_path.frames.shape
            if isinstance(job.output_path, streaming.CaptureWriter):
                shapes[f"batch.out.{k}"] = job.input_path.frames.shape
    slots = pool.slots(shapes)
    sent = []
    for k, job in enumerate(jobs):
        clip, output = job.input_path, job.output_path
        if isinstance(clip, streaming.ArrayClip):
            name = f"batch.in.{k}"
            np.copyto(slots[name].numpy(), np.asarray(clip.frames))
            clip = ((name, slots[name]), clip.fps, clip.path)
        if isinstance(output, streaming.CaptureWriter):
            name = f"batch.out.{k}"
            output = (name, slots[name]) if name in slots else None
        elif not isinstance(output, (str, os.PathLike)):
            raise TypeError(f"a batch worker writes to a path or a CaptureWriter, not {output!r}")
        sent.append(dataclasses.replace(job, input_path=clip, output_path=output))
    return sent, slots


def _run_in_worker(job: BatchJob, config, seed, chunk):
    """A worker's job: (metrics, the frames written into its output slot,
    the captured frames without one, or None for a path)."""
    clip, output = job.input_path, job.output_path
    if isinstance(clip, tuple):
        (name, frames), fps, path = clip
        clip = streaming.ArrayClip(workers.hold(name, frames).numpy(), fps=fps, path=path)
    if isinstance(output, tuple):
        writer = _SlotWriter(workers.hold(*output).numpy())
    else:
        writer = streaming.CaptureWriter() if output is None else output
    metrics = _run(dataclasses.replace(job, input_path=clip, output_path=writer), config, seed,
                   workers.device(), chunk)
    if isinstance(writer, _SlotWriter):
        return metrics, writer.count
    return metrics, (writer.frames() if output is None else None)


def stabilize_batch(
    jobs: Sequence[BatchJob],
    config: Optional[MeshFlowConfig] = None,
    devices: Optional[Sequence] = None,
    seed: int = 0,
) -> Tuple[Tuple[float, float, float], ...]:
    """Stabilize independent clips concurrently across `devices` (default:
    every CUDA device), one worker process a device; returns each job's
    (cropping_ratio, distortion_score, stability_score) in job order.

    With two or more entries and jobs the worker processes
    (``workers.pool``, one an entry, even where there are fewer jobs) stay
    up after the call, for the next call with the same list; a call with
    another list, or ``workers.shutdown()``, ends them.  Between calls each
    holds its CUDA context on its card and no other device memory.

    On the card each job's motion and metric batches run as CUDA graphs of
    the job's stabilizer (``utils/graphs.py``): a batch shape is captured
    at its second batch and replayed after, and the graphs and their pool
    (2.06 GiB on the 16x16 mesh at 640x360, H100 80GB HBM3 at 700 W) are
    freed when the job ends, in a worker process or in this one."""
    from meshflow_tpu_torch.api import MeshFlowStabilizer

    devices = device_list(devices)
    config = MeshFlowConfig() if config is None else config
    chunk = MeshFlowStabilizer.CHUNK
    num_workers = max(1, min(len(devices), len(jobs)))
    # the parent of worker processes makes no device work of its own
    with profiling.span("batch.call", device=devices[0] if num_workers == 1 else None):
        if num_workers == 1:
            return tuple(_run(job, config, seed, devices[0], chunk) for job in jobs)
        pool = workers.pool(devices)
        with profiling.span("batch.share_in"):
            sent, slots = _share_in(pool, jobs)
        with profiling.span("batch.map"):
            answers = pool.map(_run_in_worker, [(job, config, seed, chunk) for job in sent])
        with profiling.span("batch.share_out"):
            for k, (job, (_, frames)) in enumerate(zip(jobs, answers)):
                if isinstance(frames, int):
                    frames = slots[f"batch.out.{k}"][:frames].numpy()
                if frames is not None:
                    job.output_path.write(frames)
    return tuple(metrics for metrics, _ in answers)


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
