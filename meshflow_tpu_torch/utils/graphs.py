"""CUDA graphs of the port's launch-bound units: the counterpart of the
JAX package's jitted blocks.

The JAX package compiles each block of its hot path into one program
(``pair_velocity_scan_pallas``, ``cropping_and_distortion_scanned``,
``online_step``).  The port dispatches op by op, and a 16-pair match
batch is thousands of tiny launches.  ``run(runner, fn, tensors,
*static)`` runs ``fn(*tensors, *static)``: directly where `runner` is
None, else through ``runner.run``.  On a CUDA device a ``GraphRunner``
runs a unit as one CUDA graph:

* a graph is keyed by the function, the device, the static arguments
  (config, geometry) and the shapes and dtypes of the tensors;
* a key's first call runs ``fn`` eagerly on a side stream (the warm-up
  of a later capture; a unit called once is never captured);
* its second call captures ``fn`` on copies of the inputs that the graph
  keeps (its static inputs) and replays the graph for the call's result;
  a later call copies its inputs into the static inputs and replays;
* every replay's result is a clone of the graph's static outputs, so
  that a later replay does not overwrite a result already returned;
* the kernel launches a capture records (``kernels/_launch.recording``)
  are added to the wrappers' counters at each replay, so the counters
  read what they read eagerly;
* all graphs of a runner on a device share one memory pool, which holds
  the captured units' working set (2.06 GiB for the 16-pair batches on
  the 16x16 mesh, measured on an H100 80GB HBM3 at 700 W) until the
  runner's ``clear()``;
* a capture that fails raises: there is no eager fallback;
* a warm-up, a capture and a replay are each a span of the recorder
  (``utils/profiling.py``) around the runner's work, never inside the
  captured unit.

On the CPU, and for a runner made with ``enabled=False`` (the private way
to run the card eagerly for a comparison), ``run`` calls ``fn``
directly.  A runner belongs to its owner: each stabilizer has one and
clears it on ``close()`` or collection, and the parallel paths make one
a rank or a job and clear it when that ends.  A captured ``fn`` must
make no host sync and copy nothing from the host: every tensor made from
host data is made before the first call and passed in, or cached on the
device by its module.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from meshflow_tpu_torch.kernels import _launch
from meshflow_tpu_torch.utils import profiling

# Captures and replays of every runner of the process (the worker
# processes report their tasks' share).
totals: collections.Counter = collections.Counter()


class _Graph(NamedTuple):
    graph: object  # torch.cuda.CUDAGraph (or a test's stand-in)
    inputs: list  # static inputs, filled before each replay
    outputs: list  # static outputs, written by each replay
    out_spec: object
    launched: object  # collections.Counter of kernel launches a replay


def run(runner: "GraphRunner | None", fn, tensors, *static):
    """fn(*tensors, *static), through `runner` unless it is None."""
    if runner is None:
        return fn(*tensors, *static)
    return runner.run(fn, tensors, *static)


class GraphRunner:
    """Runs units as CUDA graphs on a CUDA device, eagerly elsewhere."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._graphs: dict = {}
        self._seen: set = set()
        self._pools: dict = {}
        self._streams: dict = {}
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

    def graphs_on(self, device: torch.device) -> bool:
        """Whether units on `device` run as graphs."""
        return self.enabled and device.type == "cuda"

    def run(self, fn, tensors, *static):
        """fn(*tensors, *static); `tensors` a tuple of tensors (nested
        tuples and NamedTuples allowed), `static` hashable.  Returns fn's
        tensors, as fn would.  A warm-up, a capture and a replay are spans
        (``graph.warmup:<unit>``, ``graph.capture:<unit>``,
        ``graph.replay:<unit>``, the unit fn's name); the replay's span
        holds the input copies, the launch and the output clones."""
        flat, spec = pytree.tree_flatten(tensors)
        device = flat[0].device
        if not self.graphs_on(device):
            return fn(*tensors, *static)
        unit = fn.__name__
        key = (fn, device, static, tuple((tuple(t.shape), t.dtype) for t in flat))
        entry = self._graphs.get(key)
        if entry is None and key not in self._seen:
            self._seen.add(key)
            with profiling.span("graph.warmup", unit, device):
                return self._warm_up(fn, tensors, static, device)
        captured_now = entry is None  # the capture's static inputs hold this call's
        if captured_now:
            with profiling.span("graph.capture", unit, device):
                entry = self._capture(key, fn, flat, spec, static, device)
                self.captures += 1
                totals["captures"] += 1
        with profiling.span("graph.replay", unit, device):
            if not captured_now:
                for dst, src in zip(entry.inputs, flat):
                    dst.copy_(src)
            self._replay(entry.graph, device)
            _launch.add(entry.launched)
            self.replays += 1
            totals["replays"] += 1
            return pytree.tree_unflatten([t.clone() for t in entry.outputs], entry.out_spec)

    def _stream(self, device: torch.device):
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def _pool(self, device: torch.device):
        if device not in self._pools:
            with torch.cuda.device(device):
                self._pools[device] = torch.cuda.graph_pool_handle()
        return self._pools[device]

    def _warm_up(self, fn, args, static, device):
        """fn eagerly on the capture's side stream, ordered after the
        caller's stream and before its later work.  The caching allocator
        keeps the blocks a stream frees for that stream, so, as a capture
        does, the warm-up first returns the caller's cached blocks to the
        card: the unit's working set on the side stream would otherwise
        stack on them (a clip's detection leaves ~2.8 GB cached at 640x360)."""
        torch.cuda.empty_cache()
        stream, current = self._stream(device), torch.cuda.current_stream(device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            out = fn(*args, *static)
        current.wait_stream(stream)
        for t in pytree.tree_leaves(out):
            t.record_stream(current)
        return out

    def _capture(self, key, fn, flat, spec, static, device) -> _Graph:
        """Capture fn on copies of `flat` (the graph's static inputs)."""
        start = time.perf_counter()
        inputs = [t.clone() for t in flat]
        args = pytree.tree_unflatten(inputs, spec)
        with _launch.recording() as launched:
            graph, outputs = self._record(fn, args, static, device)
        out_flat, out_spec = pytree.tree_flatten(outputs)
        entry = self._graphs[key] = _Graph(graph, inputs, out_flat, out_spec, launched)
        self.capture_seconds += time.perf_counter() - start
        return entry

    def _record(self, fn, args, static, device):
        """(graph, static outputs) of fn captured on `args`, on the side
        stream that ran its warm-up."""
        stream = self._stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))  # the inputs' copies
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(
            graph, pool=self._pool(device), stream=stream,
            capture_error_mode="thread_local",
        ):
            out = fn(*args, *static)
        return graph, out

    def _replay(self, graph, device):
        """Replay `graph` on `device`'s current stream (a replay launches on
        the current device's)."""
        with torch.cuda.device(device):
            graph.replay()

    def pool_bytes(self) -> int | None:
        """Device bytes the runner's pools hold (the caching allocator's
        segments of those pools), or None where the snapshot does not name
        segments' pools."""
        if not self._pools:
            return 0
        ids = {tuple(p) for p in self._pools.values()}
        total = 0
        for segment in torch.cuda.memory_snapshot():
            if "segment_pool_id" not in segment:
                return None
            if tuple(segment["segment_pool_id"]) in ids:
                total += segment["total_size"]
        return total

    def clear(self) -> None:
        """Free the graphs, their static buffers and their pools, and return
        the pools' memory to the card.  A key run again after is warmed up
        and captured again."""
        held = bool(self._graphs or self._pools)
        self._graphs.clear()
        self._seen.clear()
        self._pools.clear()
        self._streams.clear()
        if held and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
