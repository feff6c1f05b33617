"""Multi-card check of the PyTorch port's parallel paths: frame-sharded
stabilization and multi-clip batching over every CUDA device of one host,
held against one card.

    python3 scripts/torch_multicard.py

Needs two or more CUDA devices.  Steps:

1. ``tests/test_torch_cuda.py``'s card test that launches kernels A and B
   on the last card while the first is current;
2. sharded: ``parallel.stabilize_sharded`` on ``chip_smoke.py``'s 640x360
   x 300-frame clip with one shard on the first card, one shard on each
   card, and as many logical shards on the first card: the cards' run
   against the one shard with the JAX package's shard-count gates (crop
   equal, metrics within 1e-3 relative, frames within 1 LSB on > 99.9% of
   pixels), and whether it is bit-equal to the logical shards' run; the
   warm wall of each (a cold run first);
3. batch: one 640x360 x 120-frame clip a card through
   ``parallel.stabilize_batch`` on one worker (the first card) and on one
   worker a card: each job's metrics and frames equal to its one-worker
   run; then the first two clips on two workers of the first card.  The
   wall and the process's CPU time (every thread) of each run: CPU time
   near the wall means one core did the host work of every worker in
   turn;
4. a ``torch.profiler`` trace (CPU and CUDA) of a 30-frame clip a worker,
   one and two workers on the first card: the share of the wall in which
   the card ran a kernel.

Prints the cards' names and power limits, one line a check, then one JSON
line of the numbers.  Exits non-zero if a check fails.

    python3 scripts/torch_multicard.py --trace-only

runs step 4 alone, on one card.

    python3 scripts/torch_multicard.py --devices cpu,cpu --frames 24 --size 96x128

runs steps 2 and 3 on the CPU at a small size (no card test, no trace),
to try the script without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the clip and the gates' helpers)
from chip_smoke import check, synthetic_clip, torch_frames  # noqa: E402


def timed(fn):
    """(fn(), wall seconds, process CPU seconds of every thread), the card
    synchronized before and after."""
    import torch

    def sync():
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    sync()
    wall, cpu = time.perf_counter(), time.process_time()
    out = fn()
    sync()
    return out, time.perf_counter() - wall, time.process_time() - cpu


def shard_gates(name, got, ref):
    """The JAX package's shard-count gates of run `got` against `ref`
    (cropped frames, crop, three metrics); returns the share of pixels
    within 1 LSB."""
    import torch

    check(got[1].tolist() == ref[1].tolist(), f"{name}: crop {got[1].tolist()} != "
          f"{ref[1].tolist()}")
    rel = [abs(float(a) - float(b)) / max(abs(float(b)), 1e-12) for a, b in zip(got[2:], ref[2:])]
    check(max(rel) <= 1e-3, f"{name}: metrics off by {rel}")
    near = ((got[0].cpu().int() - ref[0].cpu().int()).abs() <= 1).float().mean().item()
    check(near > 0.999, f"{name}: frames within 1 LSB on {near} of pixels")
    print(f"{name}: crop equal, metric rel diffs {rel}, frames within 1 LSB on {near:.6f} of "
          f"pixels, bit-equal {bool(torch.equal(got[0].cpu(), ref[0].cpu()))}")
    return near


def phase_sharded(devices, num_frames, h, w):
    import torch

    from meshflow_tpu_torch.config import MeshFlowConfig
    from meshflow_tpu_torch.parallel.pipeline import stabilize_sharded
    from meshflow_tpu_torch.utils import prng

    first = devices[0]
    frames = torch.from_numpy(synthetic_clip(num_frames, h, w, pan=120)).to(first)
    key = prng.PRNGKey(chip_smoke.SEED, device=first)
    config = MeshFlowConfig()
    runs, out = {}, {}
    for name, devs in (("1 shard", [first]), (f"{len(devices)} cards", devices),
                       (f"{len(devices)} shards on one card", [first] * len(devices))):
        def run():
            return stabilize_sharded(frames, key, config, h, w, devices=devs)

        _, cold, _ = timed(run)
        runs[name], wall, cpu = timed(run)
        out[name] = {"seconds": wall, "cpu_seconds": cpu, "cold_seconds": cold}
        print(f"sharded {name}: {num_frames} frames {w}x{h}: warm {wall:.3f} s (cold "
              f"{cold:.3f}), CPU {cpu:.3f} s; crop {runs[name][1].tolist()}; metrics "
              f"{[float(x) for x in runs[name][2:]]}")
    names = list(runs)
    shard_gates(f"sharded {names[1]} against {names[0]}", runs[names[1]], runs[names[0]])
    check(all(r[0].device == torch.device(first) for r in runs.values()),
          "sharded: outputs are not on the first shard's device")
    out["cards_equal_logical"] = bool(torch.equal(runs[names[1]][0].cpu(), runs[names[2]][0].cpu()))
    print(f"sharded: the cards' run bit-equal to the logical shards' run: "
          f"{out['cards_equal_logical']}")
    return out


def run_batch(clips, devices):
    from meshflow_tpu_torch import streaming
    from meshflow_tpu_torch.parallel.batch import BatchJob, stabilize_batch

    jobs = [BatchJob(streaming.ArrayClip(f), streaming.CaptureWriter(), 0) for f in clips]
    results = stabilize_batch(jobs, devices=devices)
    return [(torch_frames(j.output_path.frames()), m) for j, m in zip(jobs, results)]


def phase_batch(devices, num_frames, h, w):
    import torch

    first = devices[0]
    clips = [synthetic_clip(num_frames, h, w, pan=60 + 30 * i) for i in range(len(devices))]
    run_batch(clips[:1], [first])  # warm-up
    out = {}
    solo, wall, cpu = timed(lambda: run_batch(clips, [first]))
    out["1 worker"] = {"clips": len(clips), "seconds": wall, "cpu_seconds": cpu}
    print(f"batch: {len(clips)} clips x {num_frames} frames {w}x{h} on 1 worker: {wall:.3f} s, "
          f"CPU {cpu:.3f} s")
    for name, clip_set, devs in (
        (f"{len(devices)} cards", clips, devices),
        ("2 workers on one card", clips[:2], [first, first]),
    ):
        got, wall, cpu = timed(lambda: run_batch(clip_set, devs))
        equal = [m == s[1] and torch.equal(f, s[0]) for (f, m), s in zip(got, solo)]
        check(all(equal), f"batch {name}: jobs equal to their 1-worker runs: {equal}")
        out[name] = {"clips": len(clip_set), "seconds": wall, "cpu_seconds": cpu}
        print(f"batch: {len(clip_set)} clips on {name}: {wall:.3f} s, CPU {cpu:.3f} s; every "
              f"job's frames and metrics equal its 1-worker run")
    return out


def busy_share(prof, device_index):
    """(kernel time union, trace span) in seconds on one card, from a
    torch.profiler trace."""
    from torch.autograd import DeviceType

    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.device_index == device_index
    )
    if not spans:
        return 0.0, 0.0
    busy, (lo, hi) = 0.0, spans[0]
    first = lo
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy += hi - lo
    return busy * 1e-6, (hi - first) * 1e-6


def phase_trace(first, num_frames, h, w):
    import torch
    from torch.profiler import ProfilerActivity, profile

    clips = [synthetic_clip(num_frames, h, w, pan=60 + 30 * i) for i in range(2)]
    index = torch.device(first).index or 0
    run_batch(clips[:1], [first])  # warm-up: the kernels' build and first launches
    out = {}
    for workers in (1, 2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall, cpu = timed(lambda: run_batch(clips, [first] * workers))
        busy, span = busy_share(prof, index)
        out[f"{workers} worker(s)"] = {"seconds": wall, "cpu_seconds": cpu,
                                       "kernel_seconds": busy, "kernel_span_seconds": span}
        share = "not measured (no device events)" if span == 0 else f"{busy / wall:.4f}"
        print(f"trace: 2 clips x {num_frames} frames on {workers} worker(s) of one card, "
              f"profiled: wall {wall:.3f} s, CPU {cpu:.3f} s, kernels running {busy:.3f} s, "
              f"busy share of the wall {share}")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", default=None,
                   help="comma-separated torch devices (default: every CUDA device)")
    p.add_argument("--frames", type=int, default=300, help="sharded clip length")
    p.add_argument("--batch-frames", type=int, default=120)
    p.add_argument("--trace-frames", type=int, default=30)
    p.add_argument("--size", default="360x640", help="HxW")
    p.add_argument("--trace-only", action="store_true", help="step 4 alone, on one card")
    args = p.parse_args()
    import torch

    h, w = map(int, args.size.split("x"))
    if args.trace_only:
        if not torch.cuda.is_available():
            print("torch_multicard: no CUDA device", file=sys.stderr)
            return 2
        print(json.dumps({"trace": phase_trace("cuda:0", args.trace_frames, h, w)}))
        return 0
    if args.devices is None:
        if torch.cuda.device_count() < 2:
            print("torch_multicard: needs two or more CUDA devices", file=sys.stderr)
            return 2
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        devices = args.devices.split(",")
    on_card = devices[0].startswith("cuda")
    results = {"devices": devices}
    if on_card:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip())
        print(f"torch {torch.__version__} cuda {torch.version.cuda}")
        start = time.perf_counter()
        test = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m", "cuda", "-p",
             "no:cacheprovider", "tests/test_torch_cuda.py", "-k", "not_current"],
            cwd=REPO, capture_output=True, text=True, timeout=900)
        print(test.stdout.strip().splitlines()[-1] if test.stdout.strip() else test.stderr)
        check(test.returncode == 0 and " passed" in test.stdout and "skipped" not in test.stdout,
              f"card test on a card that is not current:\n{test.stdout}\n{test.stderr}")
        results["card_test_seconds"] = time.perf_counter() - start
    results["sharded"] = phase_sharded(devices, args.frames, h, w)
    results["batch"] = phase_batch(devices, args.batch_frames, h, w)
    if on_card:
        try:
            results["trace"] = phase_trace(devices[0], args.trace_frames, h, w)
        except Exception as e:  # the trace is a reading, not a check
            print(f"trace: failed: {type(e).__name__}: {e}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
