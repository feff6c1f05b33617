"""Batch loop (``"loop": "batch"``): calls of the multi-clip batch over
several cards, one after another.

The configuration gives ``cards`` and ``workers_per_card``: the device
list holds each of the first ``cards`` CUDA cards ``workers_per_card``
times (the CPU as often, off the card).  Each call is
``parallel.batch.stabilize_batch`` of ``distinct_clips`` seeded clips of
``frames`` frames, each job an ``ArrayClip`` in and a ``CaptureWriter``
out, as users of the batch call it: a spawned worker process an entry,
each job through ``MeshFlowStabilizer.stabilize`` and so the two-pass
stream (``streaming.stabilize_streamed``), the frames through shared
memory both ways.  One call is in flight at a time.

Set-up makes the clips, loads the kernel library, starts the pool and
runs one call.  The window runs calls until ``seconds`` have passed and
closes when the last one ends; ``clip_fps`` is every frame of every
finished clip over the window.  A call that raises ``WorkerError`` counts
its clips as failed, and the next call starts a new pool.
``peak_mem_gib`` is the largest ``peak_reserved_bytes`` a worker reported
over set-up and window.  A traced run then makes one more call under
``profiling.recording()`` (workers record their jobs too); its spans, the
pool's start and the window's graph captures feed the per-layer readers
(``batch_spans.py``).  A profiler sees only its own process, so once the
pool is shut down a traced run profiles one more call, of the compared
clip alone on the first card: with one device entry ``stabilize_batch``
runs the job in this process, through the same ``stabilize`` and stream a
worker runs (its graphs captured afresh, as in every job).  That trace
gives the line's ``busy_s``, ``window_s`` and breakdown.  The run compares
one job of the last call, drawn from the seed, with the reference of that
clip (``reference/batch.py``), on the first card after the pool is shut
down.

A program whose worker usage has no reserved peak cannot give
``peak_mem_gib``: the run then exits before it starts any worker.  On any
error the pool is terminated, so that no worker keeps a card.  What the
workers run lives in the program's modules: this file is loaded by its
path and cannot be unpickled in a worker.
"""

from __future__ import annotations

import statistics
import time

import torch

from meshflow_tpu_torch import streaming
from meshflow_tpu_torch.parallel import batch, workers
from meshflow_tpu_torch.utils import profiling
from portbench import batch_spans, compare
from portbench.loops import Result, closed
from portbench.reference import batch as ref_batch
from portbench.reference import config as ref_config

SCORES = ("ratio_rel", "distortion_rel", "stability_rel")


def devices(cfg: dict, device) -> list:
    """The batch's device list: each card (or the CPU) once a worker."""
    device = torch.device(device)
    if device.type == "cuda":
        cards = [torch.device("cuda", i) for i in range(cfg["cards"])]
    else:
        cards = [device] * cfg["cards"]
    return [d for d in cards for _ in range(cfg["workers_per_card"])]


def supported() -> bool:
    """Whether the program's workers report their reserved peak."""
    empty = getattr(workers, "empty_usage", None)
    return empty is not None and "peak_reserved_bytes" in empty()


def call(made, config, traffic: dict, devs):
    """One ``stabilize_batch`` call of every clip: (the jobs, each job's
    (ratio, distortion, stability)), in job order.  A job's frames stay in
    its writer until ``output`` asks for them: the window does not copy
    them again."""
    jobs = [batch.BatchJob(streaming.ArrayClip(clip), streaming.CaptureWriter(),
                           traffic["adaptive_weights_definition"]) for clip in made]
    return jobs, batch.stabilize_batch(jobs, config=config, devices=devs)


def output(called, k: int):
    """Job `k`'s (frames, scores) of a ``call``."""
    jobs, scores = called
    return jobs[k].output_path.frames(), scores[k]


def usage_of_last_call() -> list:
    """Each worker's usage over the last call (``WorkerPool.last_usage``)."""
    pool = workers.current()
    return [] if pool is None else pool.last_usage


def compared_input(seed: int, cfg: dict, traffic: dict, seconds: float):
    """(every clip of a call, the index of the job a run compares)."""
    made = closed.clips(seed, cfg, traffic)
    return made, closed.compared_index(seed, len(made))


def program_output(config, cfg: dict, traffic: dict, data, device):
    made, pick = data
    try:
        return output(call(made, config, traffic, devices(cfg, device)), pick)
    finally:
        workers.shutdown()


def reference_output(cfg: dict, traffic: dict, data, device, control=False):
    """The reference of the compared job's clip: (frames on `device`,
    scores)."""
    made, pick = data
    config = compare.meshflow_config(ref_config.MeshFlowConfig, cfg, traffic)
    clip = torch.from_numpy(made[pick]).to(device)
    with compare.lower_precision(control), torch.no_grad():
        frames, _, r, d, s = ref_batch.stabilize_clips(
            [clip], config, traffic["adaptive_weights_definition"])[0]
    return frames, (float(r), float(d), float(s))


def gaps(traffic: dict, out, ref) -> dict:
    """A job's (frames, scores), host frames for the program's or frames
    on the card for the control's, against the reference's.  The batch's
    result carries no crop, so the crop is held through the frames and
    the cropping ratio."""
    frames, scores = out
    if torch.is_tensor(frames):
        frames = frames.cpu().numpy()
    rms, worst = compare.frame_gaps(frames, ref[0])
    found = {"frame_rms": rms, "worst_frame_rms": worst}
    for i, name in enumerate(SCORES):
        if traffic["scores"] or name == "stability_rel":
            found[name] = abs(scores[i] - ref[1][i]) / max(abs(ref[1][i]), 1e-12)
    return found


def run(job) -> Result:
    if not supported():
        raise SystemExit("portbench: this program's worker usage has no peak_reserved_bytes; "
                         "the batch cell cannot read peak_mem_gib (no worker started)")
    try:
        return _run(job)
    except BaseException:
        workers.shutdown(terminate=True)
        raise


def _run(job) -> Result:
    devs = devices(job.cfg, job.device)
    made = closed.clips(job.seed, job.cfg, job.traffic)
    frames, per_call = job.traffic["frames"], len(made)
    job.log(f"clips made at {job.elapsed():.3f} s: {per_call} of {frames} frames; "
            f"devices {[str(d) for d in devs]}")
    if job.on_card:
        from meshflow_tpu_torch.kernels import _build

        _build.library()  # built here, so that the pool's start is the workers' own
    profiling.clear()
    with profiling.recording(job.trace):
        workers.pool(devs)
    ctx = {"frames": frames, "setup_requests": profiling.plain(profiling.requests())}
    job.log(f"pool started at {job.elapsed():.3f} s")
    peaks = []  # each call's largest reserved peak of a worker

    def account() -> int:
        usage = usage_of_last_call()
        peaks.append(max(u["peak_reserved_bytes"] or 0 for u in usage))
        return sum(u["graphs"][0] for u in usage)

    last = call(made, job.config, job.traffic, devs)
    account()
    setup_s = job.elapsed()
    job.log(f"set-up {setup_s:.3f} s; window of {job.seconds} s")

    call_s, failed, captures, finished = [], 0, 0, 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            last = call(made, job.config, job.traffic, devs)
        except workers.WorkerError as err:
            failed += per_call
            job.log(f"call {len(call_s)} failed: {err}")
        else:
            captures += account()
            finished += per_call
        end = time.perf_counter()
        call_s.append(end - t0)
        if end - start >= job.seconds:
            break
    window_s = end - start
    job.log(f"window: {len(call_s)} calls of {per_call} clips in {window_s:.3f} s, "
            f"{failed} clips failed; median call {statistics.median(call_s):.3f} s; call "
            "seconds " + " ".join(f"{s:.3f}" for s in call_s) + "; reserved peak GiB (set-up, "
            "then each finished call) " + " ".join(f"{p / 2**30:.3f}" for p in peaks))
    job.log(f"window end: cards {job.card_state()}")
    ctx.update(window_captures=captures, window_clips=finished)
    if job.trace:
        profiling.clear()
        with profiling.recording():
            call(made, job.config, job.traffic, devs)
        ctx["call_requests"] = profiling.plain(profiling.requests())
        ctx["worker_requests"] = [u["requests"] for u in usage_of_last_call()]
        ctx["call_frames"] = frames * per_call
        job.log("traced call: " + ", ".join(
            f"{s['name']} {batch_spans.host_ms(s):.1f}" for r in ctx["call_requests"]
            for s in r["spans"]) + " host ms; workers' jobs (stabilize, stream.pass1, "
            "stream.pass2 host ms): " + "; ".join(" ".join(
                "/".join(f"{batch_spans.host_ms(s):.0f}" for s in r["spans"]
                         if s["name"] in ("stabilize", "stream.pass1", "stream.pass2"))
                for r in requests) for requests in ctx["worker_requests"]))
    workers.shutdown()
    pick = closed.compared_index(job.seed, per_call)
    summary = None
    if job.trace:
        _, summary = job.profile(
            lambda: call(made[pick:pick + 1], job.config, job.traffic, devs[:1]))
    job.free()

    t_ref = time.perf_counter()
    ref = reference_output(job.cfg, job.traffic, (made, pick), job.device)
    job.log(f"reference: {time.perf_counter() - t_ref:.3f} s; compared job {pick} of "
            f"{per_call} (the last call's)")
    return Result(setup_s=setup_s, e2e={"clip_fps": finished * frames / window_s},
                  attempted=len(call_s) * per_call, failed=failed, peak_bytes=max(peaks),
                  gaps=gaps(job.traffic, output(last, pick), ref), ctx=ctx,
                  summary=summary)
