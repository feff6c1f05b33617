"""Closed loop (``"loop": "closed"``): whole clips, one after another.

``distinct_clips`` seeded clips of ``frames`` frames are made in set-up;
the window runs them in turn, each uploaded from host memory, run through
``MeshFlowStabilizer._stabilize_frames`` and copied back with its scores,
as ``stabilize()``'s in-memory route does between decode and encode.
Clips start while the window's ``seconds`` have not passed; the window
closes when the last one ends.  ``clip_fps`` is every frame of every clip
over the window.  The traffic file also gives ``pan_of_width``,
``jitter_px``, ``scores`` and ``adaptive_weights_definition``.

Set-up runs one clip (``WARM_PASSES``): it meets every shape of the
window, and the graph runner captures each batch's graph at that batch's
second call, which the clip's 19 motion and 19 metric batches of one
shape reach.  The run compares one clip the window finished, drawn from
the seed, with its last output.
"""

from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from meshflow_tpu_torch.api import MeshFlowStabilizer
from portbench import compare
from portbench.clips import synthetic_clip
from portbench.loops import LabeledTimer, Result

WARM_PASSES = 1


def clips(seed: int, cfg: dict, traffic: dict):
    """The loop's distinct clips, host uint8 (F, H, W, 3) each."""
    h, w = cfg["height"], cfg["width"]
    pan = traffic["pan_of_width"] * w
    return [synthetic_clip([seed, i], traffic["frames"], h, w, pan, traffic["jitter_px"])
            for i in range(traffic["distinct_clips"])]


def compared_index(seed: int, finished: int) -> int:
    """The clip a run compares, of the first `finished` clips."""
    return int(np.random.default_rng([seed, 1]).integers(finished))


def compared_input(seed: int, cfg: dict, traffic: dict, seconds: float):
    """The clip a run compares when its window ran every clip."""
    made = clips(seed, cfg, traffic)
    return made[compared_index(seed, len(made))]


class ClipRunner:
    """One stabilizer serving whole clips the way ``stabilize()`` does."""

    def __init__(self, config, traffic: dict, device):
        self.device = torch.device(device)
        self.awd = traffic["adaptive_weights_definition"]
        self.stab = MeshFlowStabilizer(config=config, device=self.device)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, clip: np.ndarray, timer=None, times=None):
        """Upload, stabilize, copy back: (frames, crop, (ratio, distortion,
        stability)) on the host.  times, a dict, gets the upload and copy-back
        seconds (with the card synchronized around them)."""
        timer = timer or LabeledTimer(False, self.device)
        if times is not None:
            self.sync()
            t0 = time.perf_counter()
        frames = torch.from_numpy(clip).to(self.device)
        if times is not None:
            self.sync()
            times["upload_s"] = time.perf_counter() - t0
        cropped, ratio, distortion, stability = self.stab._stabilize_frames(
            frames, self.awd, timer)
        if times is not None:
            self.sync()
            t0 = time.perf_counter()
        out = cropped.cpu().numpy()
        scores = (float(ratio), float(distortion), float(stability))
        crop = self.stab.last_crop.cpu().numpy()
        if times is not None:
            times["download_s"] = time.perf_counter() - t0
        return out, crop, scores

    def close(self):
        self.stab.close()


def window(runner: ClipRunner, made, seconds: float):
    """Run clips in turn until `seconds` have passed; returns (each clip's
    seconds, window seconds, {clip index: its last output})."""
    kept, ends = {}, []
    start = time.perf_counter()
    while True:
        k = len(ends) % len(made)
        kept[k] = runner.run(made[k])
        ends.append(time.perf_counter())
        if ends[-1] - start >= seconds:
            break
    return list(np.diff([start] + ends)), ends[-1] - start, kept


def program_output(config, cfg: dict, traffic: dict, data, device):
    runner = ClipRunner(config, traffic, device)
    out = runner.run(data)
    runner.close()
    return out


def reference_output(cfg: dict, traffic: dict, data, device, control=False, lk_work=None):
    return compare.reference_clip(data, cfg, traffic, device, control=control, lk_work=lk_work)


def gaps(traffic: dict, out, ref) -> dict:
    """`out` the program's (host arrays) or the control's (frames on the
    card) against the reference's `ref`."""
    if torch.is_tensor(out[0]):
        out = (out[0].cpu().numpy(), out[1], out[2])
    return compare.clip_gaps(out, ref, traffic["scores"])


def run(job) -> Result:
    made = clips(job.seed, job.cfg, job.traffic)
    job.log(f"clips made at {job.elapsed():.3f} s")
    runner = ClipRunner(job.config, job.traffic, job.device)
    for _ in range(WARM_PASSES):
        runner.run(made[0])
        job.sync()
        job.log(f"warm pass done at {job.elapsed():.3f} s")
    setup_s = job.elapsed()
    job.log(f"set-up {setup_s:.3f} s; window of {job.seconds} s")
    with job.watched(runner.stab._runner):
        clip_s, window_s, kept = window(runner, made, job.seconds)
    peak = job.peak_bytes()
    count, frames = len(clip_s), job.traffic["frames"]
    job.log(f"window: {count} clips of {frames} frames in {window_s:.3f} s; first clip "
            f"{clip_s[0]:.3f} s, median {statistics.median(clip_s):.3f} s; clip seconds "
            + " ".join(f"{s:.3f}" for s in clip_s))
    pick = compared_index(job.seed, min(len(made), count))
    ctx, summary = {"frames": frames}, None
    if job.trace:
        ctx["pool_bytes"] = runner.stab._runner.pool_bytes() if job.on_card else None
        timer, times = LabeledTimer(True, job.device), {}
        runner.run(made[pick], timer=timer, times=times)
        stages = {}
        for name, s in timer.stages:
            stages[name] = stages.get(name, 0.0) + s
        ctx["stages"] = stages
        ctx["transfer_s"] = times["upload_s"] + times["download_s"]
        _, summary = job.profile(lambda: runner.run(made[pick]))
    runner.close()
    del runner
    job.free()
    lk_work = [] if job.trace else None
    t_ref = time.perf_counter()
    ref = reference_output(job.cfg, job.traffic, made[pick], job.device, lk_work=lk_work)
    job.log(f"reference: {time.perf_counter() - t_ref:.3f} s; compared clip {pick} of "
            f"{len(made)} (its last run in the window)")
    ctx["lk_work"] = lk_work
    return Result(setup_s=setup_s, e2e={"clip_fps": count * frames / window_s},
                  attempted=count, failed=0, peak_bytes=peak,
                  gaps=gaps(job.traffic, kept[pick], ref), ctx=ctx, summary=summary)
