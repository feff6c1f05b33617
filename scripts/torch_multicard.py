"""Multi-card check of the PyTorch port's parallel paths: frame-sharded
stabilization and multi-clip batching over every CUDA device of one host,
one process a device, held against one card.

    python3 scripts/torch_multicard.py

Needs two or more CUDA devices.  Steps:

1. ``tests/test_torch_cuda.py``'s card test that launches kernels A and B
   on the last card while the first is current;
2. sharded: ``parallel.stabilize_sharded`` on ``chip_smoke.py``'s 640x360
   x 300-frame clip with one shard (this process), one shard on each card
   (a process a card, NCCL) and as many logical shards on the first card
   (a process each, gloo): the cards' run against the one shard with the
   JAX package's shard-count gates (crop equal, metrics within 1e-3
   relative, frames within 1 LSB on > 99.9% of pixels), and whether it is
   bit-equal to the logical shards' run; the cold and warm wall of each;
3. batch: one 640x360 x 120-frame clip a card through
   ``parallel.stabilize_batch`` on one worker (this process, the first
   card) and on a worker process a card: each job's metrics and frames
   equal to its one-worker run; then the first two clips on two worker
   processes of the first card; with each layout, the device memory its
   idle workers hold on each card (in use after the call less before the
   pool started, this process's cache emptied);
4. busy share: one worker on the first card and a worker a card, each
   card's share of the wall in which it ran kernels as nvidia-smi samples
   it (``chip_smoke.card_utilization``), and for one worker also from a
   ``torch.profiler`` trace (traced in several processes at once, runs
   took over ten times their wall).

Every run reports its wall and the CPU seconds of this process and of
each worker process (a pool's workers live on between calls, so
``RUSAGE_CHILDREN`` would miss them: each reports its own), and of every
warm run the busiest threads of each process, read from /proc
(``chip_smoke.cpu_use``).  ``--trace-only`` runs step 4 on the first card
alone.

    python3 scripts/torch_multicard.py --devices cpu,cpu --frames 24 --size 96x128

runs steps 2 and 3 on the CPU at a small size (no card test, no trace),
to try the script without a card.

Prints the cards' names and power limits, one line a check, then one JSON
line of the numbers.  Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the clip and the gates' helpers)
from chip_smoke import check, synthetic_clip, torch_frames  # noqa: E402


def sync():
    import torch

    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def timed(fn, devices=()):
    """(fn(), wall seconds, CPU seconds of this process, CPU seconds of
    each worker process of `devices`' pool in the call, the busiest
    threads of each process: ``chip_smoke.cpu_use``), the cards
    synchronized before and after."""
    from meshflow_tpu_torch.parallel import device_list, workers

    sync()
    with chip_smoke.cpu_use() as use:
        wall, cpu = time.perf_counter(), time.process_time()
        out = fn()
        sync()
        wall, cpu = time.perf_counter() - wall, time.process_time() - cpu
    children = []
    if len(devices) > 1:
        children = [u["cpu_seconds"] for u in workers.pool(device_list(devices)).last_usage]
    return out, wall, cpu, children, use


def record(wall, cpu, children, use, **extra):
    return {"seconds": wall, "cpu_seconds": cpu + sum(children), "parent_cpu_seconds": cpu,
            "worker_cpu_seconds": children, "threads": use.by_process, **extra}


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
    from meshflow_tpu_torch.parallel import device_list, workers
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

        _, cold, _, _, _ = timed(run, devs)
        runs[name], wall, cpu, children, use = timed(run, devs)
        backend = workers.pool(device_list(devs)).backend if len(devs) > 1 else None
        out[name] = record(wall, cpu, children, use, cold_seconds=cold, backend=backend,
                           processes=len(devs))
        print(f"sharded {name}: {num_frames} frames {w}x{h}: warm {wall:.3f} s (cold "
              f"{cold:.3f}), {len(devs)} process(es), backend {backend}; CPU {cpu:.3f} s here, "
              f"workers {[round(c, 3) for c in children]}; crop {runs[name][1].tolist()}; "
              f"metrics {[float(x) for x in runs[name][2:]]}; CPU by process and thread: "
              f"{use.line()}")
        workers.shutdown()
    names = list(runs)
    shard_gates(f"sharded {names[1]} against {names[0]}", runs[names[1]], runs[names[0]])
    check(all(r[0].device == device_list([first])[0] for r in runs.values()),
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


def card_used_gib(devices) -> dict:
    """{card index: GiB in use by every process} of the cards in
    `devices` (mem_get_info), this process's cache emptied first; empty
    on the CPU."""
    import torch

    from meshflow_tpu_torch.parallel import device_list

    cards = sorted({d.index for d in device_list(devices) if d.type == "cuda"})
    if cards:
        torch.cuda.empty_cache()
    used = {}
    for i in cards:
        free, total = torch.cuda.mem_get_info(i)
        used[i] = (total - free) / (1 << 30)
    return used


def phase_batch(devices, num_frames, h, w):
    import torch

    from meshflow_tpu_torch.parallel import workers

    first = devices[0]
    clips = [synthetic_clip(num_frames, h, w, pan=60 + 30 * i) for i in range(len(devices))]
    run_batch(clips[:1], [first])  # warm-up
    out = {}
    solo, wall, cpu, _, use = timed(lambda: run_batch(clips, [first]))
    out["1 worker"] = record(wall, cpu, [], use, clips=len(clips))
    print(f"batch: {len(clips)} clips x {num_frames} frames {w}x{h} on 1 worker: {wall:.3f} s, "
          f"CPU {cpu:.3f} s; by thread: {use.line()}")
    for name, clip_set, devs in (
        (f"{len(devices)} cards", clips, devices),
        ("2 workers on one card", clips[:2], [first, first]),
    ):
        before = card_used_gib(devs)
        _, cold, _, _, _ = timed(lambda: run_batch(clip_set, devs), devs)
        got, wall, cpu, children, use = timed(lambda: run_batch(clip_set, devs), devs)
        after = card_used_gib(devs)
        idle = {i: after[i] - before[i] for i in after}  # the idle workers' share of each card
        workers.shutdown()
        equal = [m == s[1] and torch.equal(f, s[0]) for (f, m), s in zip(got, solo)]
        check(all(equal), f"batch {name}: jobs equal to their 1-worker runs: {equal}")
        out[name] = record(wall, cpu, children, use, clips=len(clip_set), cold_seconds=cold,
                           idle_workers_gib=idle)
        print(f"batch: {len(clip_set)} clips on {name}, a process each: warm {wall:.3f} s "
              f"(cold {cold:.3f}), CPU {cpu:.3f} s here, workers "
              f"{[round(c, 3) for c in children]}; every job's frames and metrics equal its "
              f"1-worker run; CPU by process and thread: {use.line()}; card memory the idle "
              f"workers hold, GiB by card: {idle}")
    return out


def phase_trace(devices, num_frames, h, w):
    """Step 4: the share of the wall each card ran kernels, as nvidia-smi
    samples it (one worker: also from a ``torch.profiler`` trace)."""
    from torch.profiler import ProfilerActivity, profile

    from meshflow_tpu_torch.parallel import device_list, workers

    first = devices[0]
    clips = [synthetic_clip(num_frames, h, w, pan=60 + 30 * i)
             for i in range(max(2, len(devices)))]
    run_batch(clips[:1], [first])  # warm-up: the kernels' build and first launches
    layouts = [("1 worker", clips[:2], [first])]
    if len(devices) > 1:
        layouts.append((f"{len(devices)} cards", clips[:len(devices)], devices))
    out = {}
    for name, clip_set, devs in layouts:
        if len(devs) > 1:
            run_batch(clip_set, devs)  # the workers' start and first launches
        with chip_smoke.card_utilization() as smi:
            _, wall, cpu, children, use = timed(lambda: run_batch(clip_set, devs), devs)
        out[name] = record(wall, cpu, children, use, smi_busy=smi.share)
        line = (f"busy: {len(clip_set)} clips x {num_frames} frames on {name}: wall {wall:.3f} "
                f"s, CPU {cpu:.3f} s here, workers {[round(c, 3) for c in children]}; busy "
                f"share of each card (nvidia-smi) {smi.share}")
        if len(devs) == 1:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, traced, _, _, _ = timed(lambda: run_batch(clip_set, devs))
            busy = chip_smoke.kernel_busy_seconds(prof, device_list([first])[0].index)
            out[name].update(traced_seconds=traced, kernel_seconds=busy)
            line += f"; traced again: {traced:.3f} s, kernels {busy:.3f} s ({busy / traced:.4f})"
        workers.shutdown()
        print(line)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", default=None,
                   help="comma-separated torch devices (default: every CUDA device)")
    p.add_argument("--frames", type=int, default=300, help="sharded clip length")
    p.add_argument("--batch-frames", type=int, default=120)
    p.add_argument("--trace-frames", type=int, default=120)
    p.add_argument("--size", default="360x640", help="HxW")
    p.add_argument("--trace-only", action="store_true", help="step 4 alone, on the first card")
    args = p.parse_args()
    import torch

    h, w = map(int, args.size.split("x"))
    if args.trace_only:
        if not torch.cuda.is_available():
            print("torch_multicard: no CUDA device", file=sys.stderr)
            return 2
        print(chip_smoke.smi_query("name,power.limit"))
        print(json.dumps({"trace": phase_trace(["cuda:0"], args.trace_frames, h, w)}))
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
        print(chip_smoke.smi_query("name,power.limit"))
        with open("/proc/self/maps") as f:
            openmp = sorted({Path(x).name for x in re.findall(r"\S*(?:gomp|iomp)\S*", f.read())})
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; OpenMP library {openmp}; "
              + "; ".join(torch.__config__.parallel_info().strip().splitlines()[:6]))
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
            results["trace"] = phase_trace(devices, args.trace_frames, h, w)
        except Exception:  # the trace is a reading, not a check
            print(f"trace: failed:\n{traceback.format_exc()}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
