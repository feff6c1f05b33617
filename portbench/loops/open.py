"""Open loop (``"loop": "open"``): one live session, frame by frame.

One session of ``OnlineMeshFlowStabilizer.process``; set-up feeds its
first ``warm_frames`` frames (the step's graph capture among them), then
frame i of the window is due at ``start + i / fps`` whatever the
stabilizer is doing, and its latency runs from when it was due to when
its stabilized frame is back on the host.  ``frame_p95_ms`` is the 95th
percentile over the window's frames; a frame not started ``GRACE_S``
after the last due time is failed and counted at the window's end.  A
traced run profiles ``trace_frames`` more frames of the same session.
The traffic file also gives ``pan_px_per_frame``, ``jitter_px``,
``crop_ratio`` and ``adaptive_weights_definition``.  The run compares
every frame the session returned.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from meshflow_tpu_torch.online import OnlineMeshFlowStabilizer
from portbench import compare
from portbench.clips import synthetic_clip
from portbench.loops import Result

GRACE_S = 5.0  # the window closes this long after its last frame's due time


def window_frames(traffic: dict, seconds: float) -> int:
    return int(round(seconds * traffic["fps"]))


def session(seed: int, cfg: dict, traffic: dict, seconds: float):
    """The session's frames: warm frames, the window's frames and the
    frames a traced run profiles after them (made in every run, so that a
    seed gives the same frames with tracing on or off)."""
    h, w = cfg["height"], cfg["width"]
    count = traffic["warm_frames"] + window_frames(traffic, seconds) + traffic["trace_frames"]
    pan = traffic["pan_px_per_frame"] * (count - 1)
    return synthetic_clip([seed, 0], count, h, w, pan, traffic["jitter_px"])


def compared_input(seed: int, cfg: dict, traffic: dict, seconds: float):
    """The warm and window frames of the session, which a run compares."""
    return session(seed, cfg, traffic, seconds)[:traffic["warm_frames"]
                                                + window_frames(traffic, seconds)]


def stabilizer(config, traffic: dict, device):
    return OnlineMeshFlowStabilizer(
        config=config, adaptive_weights_definition=traffic["adaptive_weights_definition"],
        crop_ratio=traffic["crop_ratio"], device=device)


def feed(stab, frames, fps: float, mark: bool = False):
    """Feed `frames` at `fps` from now on: returns (outputs, latencies s,
    call seconds, window seconds); a frame not started by GRACE_S after the
    last due time is left out (failed).  mark: each call is a
    ``portbench.frame`` span for the profiler."""
    outs, latency, calls = [], [], []
    start = time.perf_counter() + 0.01
    last_due = start + (len(frames) - 1) / fps
    for i, frame in enumerate(frames):
        due = start + i / fps
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
        elif now > last_due + GRACE_S:
            break
        t0 = time.perf_counter()
        if mark:
            with torch.profiler.record_function("portbench.frame"):
                out = stab.process(frame)
        else:
            out = stab.process(frame)
        t1 = time.perf_counter()
        outs.append(out)
        latency.append(t1 - due)
        calls.append(t1 - t0)
    return outs, latency, calls, time.perf_counter() - start


def program_output(config, cfg: dict, traffic: dict, data, device):
    stab = stabilizer(config, traffic, device)
    out = [stab.process(f) for f in data]
    stab.close()
    return out


def reference_output(cfg: dict, traffic: dict, data, device, control=False):
    return compare.reference_session(data, cfg, traffic, device, control=control)


def gaps(traffic: dict, out, ref) -> dict:
    """`out` the program's frames (a list of host frames) or the control's
    (frames on the card) against the reference's `ref`."""
    frames = out.cpu().numpy() if torch.is_tensor(out) else out
    return compare.session_gaps(list(frames), ref)


def run(job) -> Result:
    fps, warm = job.traffic["fps"], job.traffic["warm_frames"]
    frames = session(job.seed, job.cfg, job.traffic, job.seconds)
    n_win = window_frames(job.traffic, job.seconds)
    stab = stabilizer(job.config, job.traffic, job.device)
    outs = [stab.process(f) for f in frames[:warm]]
    job.sync()
    setup_s = job.elapsed()
    job.log(f"set-up {setup_s:.3f} s; window of {n_win} frames at {fps} frames/s")
    with job.watched(stab._runner):
        got, latency, calls, window_s = feed(stab, frames[warm:warm + n_win], fps)
    peak = job.peak_bytes()
    failed = n_win - len(got)
    late = [window_s - i / fps for i in range(len(got), n_win)]
    lat_ms = np.asarray(latency + late) * 1e3
    p95 = float(np.percentile(lat_ms, 95))
    job.log(f"window: {len(got)} of {n_win} frames returned in {window_s:.3f} s, latency p50 "
            f"{np.percentile(lat_ms, 50):.3f} ms, p95 {p95:.3f} ms")
    outs += got
    ctx, summary = {"step_ms": [c * 1e3 for c in calls]}, None
    if job.trace:
        ctx["pool_bytes"] = stab._runner.pool_bytes() if job.on_card else None
        traced, summary = job.profile(
            lambda: feed(stab, frames[warm + n_win:], fps, mark=True)[0])
        if not failed:
            outs += traced
    stab.close()
    del stab
    job.free()
    t_ref = time.perf_counter()
    ref = reference_output(job.cfg, job.traffic, frames[:len(outs)], job.device)
    job.log(f"reference: {time.perf_counter() - t_ref:.3f} s; compared all {len(outs)} frames "
            f"of the session")
    return Result(setup_s=setup_s, e2e={"frame_p95_ms": p95}, attempted=n_win, failed=failed,
                  peak_bytes=peak, gaps=gaps(job.traffic, outs, ref), ctx=ctx, summary=summary)
