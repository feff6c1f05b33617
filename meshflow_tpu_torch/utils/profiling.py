"""Stage progress and timing: the port of ``meshflow_tpu/utils/profiling.py``.

Enable the timing report: MESHFLOW_TIMINGS=1 (prints a per-stage table).
Enable device traces: MESHFLOW_TRACE_DIR=/path (one Chrome trace per
stage, ``<stage>.json``, recorded by ``torch.profiler``).

PyTorch returns before the card finishes, so an enabled timer on a CUDA
device ends every stage with ``torch.cuda.synchronize()``; a disabled
timer, or one on the CPU, never synchronizes.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


class StageTimer:
    """Collects per-stage wall times for one run."""

    def __init__(self, enabled: Optional[bool] = None, device=None):
        self.enabled = (
            enabled
            if enabled is not None
            else os.environ.get("MESHFLOW_TIMINGS", "") not in ("", "0")
        )
        self.trace_dir = os.environ.get("MESHFLOW_TRACE_DIR")
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.stages: List[tuple] = []

    def _trace(self, name: str):
        if not self.trace_dir:
            return contextlib.nullcontext()
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        path = os.path.join(self.trace_dir, name.replace(" ", "_") + ".json")

        def export(prof):
            os.makedirs(self.trace_dir, exist_ok=True)
            prof.export_chrome_trace(path)

        return torch.profiler.profile(activities=activities, on_trace_ready=export)

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        with self._trace(name):
            yield
            if self.enabled and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.stages.append((name, time.perf_counter() - start))

    def report(self) -> Dict[str, float]:
        table = {name: seconds for name, seconds in self.stages}
        if self.enabled:
            total = sum(table.values())
            width = max((len(n) for n in table), default=0)
            for name, seconds in self.stages:
                print(f"  {name:<{width}}  {seconds:7.2f}s  ({100*seconds/max(total,1e-9):4.1f}%)")
            print(f"  {'total':<{width}}  {total:7.2f}s")
        return table
