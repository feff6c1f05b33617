"""The traffic generator's loop kinds, one module each: a traffic file's
``"loop"`` names ``loops/<loop>.py``, which the harness loads by its path,
so that a later change adds a kind of loop as a new file.

A loop module gives:

* ``run(job)``: set-up (counted from ``job.t0``), the measured window, and
  where ``job.trace`` the passes the per-layer metrics read; then the
  program's state freed and the sampled outputs held against the
  reference.  Returns a ``Result``.
* ``compared_input(seed, cfg, traffic, seconds)``: the inputs whose
  outputs a run compares for `seed`.
* ``program_output(config, cfg, traffic, data, device)``: the program's
  output of `data` through the window's entry.
* ``reference_output(cfg, traffic, data, device, control)``: the plain
  reference's (``control``: one precision lower, ``compare.py``).
* ``gaps(traffic, out, ref)``: the numbers compared, {name: gap}.

``control.py`` reads limits through the last four.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import torch

from meshflow_tpu_torch.utils.profiling import StageTimer

CARD_QUERY = ("clocks.sm,clocks.mem,temperature.gpu,power.draw,"
              "clocks_throttle_reasons.active")


def load(bench: Path, name: str):
    """The module ``<bench>/loops/<name>.py``."""
    path = Path(bench) / "loops" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"portbench: no loop kind {name!r} ({path})")
    spec = importlib.util.spec_from_file_location("portbench_loop_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Job:
    """One run's settings, as a loop module gets them."""

    seed: int
    seconds: float
    trace: bool
    cfg: dict  # the configuration file
    traffic: dict  # the traffic file
    config: object  # the program's MeshFlowConfig
    device: torch.device
    t0: float  # perf_counter at the process's start: set-up counts from it

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def log(self, *parts):
        print(*parts, file=sys.stderr, flush=True)

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        """Device memory reserved at its peak so far (0 off the card)."""
        return int(torch.cuda.max_memory_reserved(self.device)) if self.on_card else 0

    def free(self):
        """Return the freed program's cached blocks before the reference runs."""
        import gc

        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def profile(self, fn):
        """fn() under torch.profiler, inside a ``portbench.window`` span:
        (fn's value, ``trace.summarize`` of the span)."""
        from portbench import trace

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function("portbench.window"):
                value = fn()
                self.sync()
        summary = trace.summarize(prof)
        del prof
        self.log(f"trace: window {summary['window_s']:.6f} s, device busy "
                 f"{summary['busy_s']:.6f} s, {sum(summary['kernel_counts'].values())} device "
                 f"operations, {summary['launches']} kernel and {summary['graph_launches']} "
                 f"graph launches, {summary['frames']} frames")
        return value, summary

    @contextlib.contextmanager
    def watched(self, graph_runner=None):
        """Log, as the block (the window) starts and ends, this process's CPU
        seconds, the device allocator's cudaMalloc count and segments, and
        the graph captures of `graph_runner`: none of them may grow inside
        the window once set-up warmed it.  At the end also the card's clocks,
        temperature, power and throttle reasons (nvidia-smi, a process of
        its own: queried only after the block, so that it perturbs no part
        of it)."""
        start = self._program_state(graph_runner)
        yield
        end = self._program_state(graph_runner)
        self.log("window: " + ", ".join(
            f"{key} {start[key]:.3f} -> {end[key]:.3f}" if isinstance(start[key], float)
            else f"{key} {start[key]} -> {end[key]}" for key in start))
        self.log(f"window end: card ({CARD_QUERY}) {self.card_state()}")

    def _program_state(self, graph_runner) -> dict:
        state = {"process CPU s": time.process_time(), "wall s": time.perf_counter()}
        if self.on_card:
            stats = torch.cuda.memory_stats(self.device)
            state["cudaMalloc calls"] = stats.get("num_device_alloc", "n/a")
            state["segments"] = stats.get("segment.all.current", "n/a")
        if graph_runner is not None:
            state["graph captures"] = graph_runner.captures
        return state

    def card_state(self) -> str:
        if not self.on_card:
            return "no card"
        try:
            out = subprocess.run(
                ["nvidia-smi", f"--query-gpu={CARD_QUERY}", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=20)
            return (out.stdout.strip() or out.stderr.strip()).replace("\n", "; ")
        except (OSError, subprocess.SubprocessError) as err:
            return f"nvidia-smi: {err}"


@dataclasses.dataclass
class Result:
    """What a loop's run hands back to the harness."""

    setup_s: float
    e2e: dict  # the loop's end-to-end metrics, setup_s and peak_mem_gib aside
    attempted: int
    failed: int
    peak_bytes: int  # read once the window closed, before the reference ran
    gaps: dict  # the numbers compared, held against limits/<cell>.json
    ctx: dict = dataclasses.field(default_factory=dict)  # for the per-layer readers
    summary: dict | None = None  # trace.summarize of the profiled span


class LabeledTimer(StageTimer):
    """The port's stage timer with each stage also marked for the profiler
    (``stage:<name>``), so that idle gaps can be put down to a stage; it
    never writes traces of its own."""

    def __init__(self, enabled: bool, device):
        super().__init__(enabled=enabled, device=device)
        self.trace_dir = None

    @contextlib.contextmanager
    def stage(self, name):
        with torch.profiler.record_function("stage:" + name):
            with super().stage(name):
                yield
