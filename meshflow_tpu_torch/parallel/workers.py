"""One host process a device entry: the worker processes behind
``batch.stabilize_batch`` and ``pipeline.stabilize_sharded``.

Outside its graphed match batches the port runs eagerly: a 640x360 pass
still makes tens of thousands of CUDA launches, each a few Python calls
under the interpreter's lock, so threads of one interpreter share one
launch rate.  The JAX package dispatches each block
as one compiled program with the lock released; the port's counterpart
is an interpreter a device.  ``pool(devices)`` starts one spawned child
for each entry of `devices` (an entry may repeat: two children on
``cuda:0``, or on the CPU), makes the entry the child's current device
and gives it an equal share of the parent's intra-op threads (N children
with the parent's count each would oversubscribe the host's cores).

One pool lives at a time.  It is kept for later calls with the same list,
and closed by a call with another list, by ``shutdown()`` or at the
interpreter's exit.  An idle child costs its CUDA context on its card and
nothing else of the device: a task's CUDA graphs and their pool belong to
the task's runner (a batch job's stabilizer, a sharded rank's step),
which frees them when it ends, and the child empties its caching
allocator after every task.  The pool also keeps the shared host buffers
of the sharded path between calls of one shape (``WorkerPool.shared``),
and a child keeps its last task's arguments until the next task has
arrived, so a buffer sent again maps to the pages the child already has.

The batch's frames live in slots (``WorkerPool.slots``): uint8 tensors in
shared memory that the pool keeps by name, apart from ``shared``'s
buffers, and reuses while a call's frames fit them, so that a call
copies into pages already made instead of faulting in new ones.  A child
holds each slot it was sent under the slot's name (``hold``), so that its
next job on that slot finds the storage, and the pages, still mapped;
when the pool drops or replaces a slot it has every child let go of it.
The slots live until the pool closes.

A child says it is ready once it has imported the port and made its
device current; the pool's start (span ``batch.pool_start``) waits for
every child, and a child that exits first raises ``WorkerError`` there.
A task is a picklable function and its arguments, sent over the child's
pipe with the parent's ``MESHFLOW_*`` environment of the call (a child
does not see what the parent changes after it started).  The child
answers with the result and its usage: the launches of the kernel
wrappers during the task, which the parent adds into its own wrappers'
``.launches``; the CUDA graphs it captured and replayed; the task's CPU
seconds; the device's peak memory, allocated (``peak_bytes``) and
reserved (``peak_reserved_bytes``, where a CUDA graph's pool sits); and,
when the parent's span recorder was on as the call began, the task's
ended requests as ``profiling.plain`` records (``requests``: the child
records the task under ``profiling.recording()``).  ``last_usage`` keeps
these per child over a call.  A
child's exception is raised again in the parent as ``WorkerError`` with
the child's traceback, and a child that exits raises one with its exit
code; either closes the pool, so that no rank is left waiting in a
collective.

The sharded path's ranks are these children with a ``torch.distributed``
group over them (``WorkerPool.init_group``): NCCL when every entry is a
distinct card, gloo when entries repeat (NCCL takes one rank a card) or
lie on the CPU.  ``Collectives`` is one rank's side of the JAX package's
``shard_map`` collectives over that group.
"""

from __future__ import annotations

import atexit
import math
import os
import shutil
import signal
import tempfile
import time
import traceback
from multiprocessing import connection

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from meshflow_tpu_torch.utils import graphs, profiling

_POOL = None  # the live pool, if any
_DEVICE = None  # a child's device; None in a process that is no worker
_HELD = {}  # a child's slots by name (``hold``)


class WorkerError(RuntimeError):
    """A worker process raised or exited."""


def device():
    """The device of the worker process this runs in (None outside one)."""
    return _DEVICE


def backend_for(devices) -> str:
    """The process group's backend for a device list: NCCL when every
    entry is a distinct card, gloo otherwise."""
    distinct_cards = all(d.type == "cuda" for d in devices) and len(set(devices)) == len(devices)
    return "nccl" if distinct_cards else "gloo"


def pool(devices) -> "WorkerPool":
    """The pool with one child for each entry of `devices` (torch devices
    with their index resolved), started at the first call with this list;
    the pool of another list is closed first."""
    devices = [torch.device(d) for d in devices]
    if _POOL is None or _POOL.devices != devices:
        shutdown()
        WorkerPool(devices)
    return _POOL


def shared_empty(shape, dtype) -> torch.Tensor:
    """An uninitialised CPU tensor allocated in shared memory at once
    (``share_memory_`` on a new tensor would copy its private pages
    across, a parallel copy on the caller's intra-op threads)."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    storage = torch.UntypedStorage._new_shared(nbytes)
    return torch.empty(0, dtype=dtype).set_(storage).view(tuple(shape))


def hold(name: str, tensor: torch.Tensor) -> torch.Tensor:
    """`tensor`, a slot sent to this child, held under the slot's `name`
    until the pool has the child let go of it: while its storage lives,
    torch's sharing finds it again when the slot is sent anew, instead of
    mapping it afresh."""
    _HELD[name] = tensor
    return tensor


def _let_go(names) -> None:
    """A child's side of a dropped or replaced slot."""
    for name in names:
        _HELD.pop(name, None)


def current() -> "WorkerPool | None":
    """The live pool, if any (none is started)."""
    return _POOL


def shutdown(terminate: bool = False) -> None:
    """Close the live pool: the children exit (at once with `terminate`)
    and their device memory is freed."""
    if _POOL is not None:
        _POOL.close(terminate)


atexit.register(shutdown)


def _wrappers() -> dict:
    """The kernel wrappers of the parallel paths, by name."""
    from meshflow_tpu_torch.kernels import bmap_cuda, eig9_cuda, lk_band_cuda, lk_cuda

    return {"lk_level": lk_cuda.lk_level, "lk_band": lk_band_cuda.lk_level_band,
            "backward_map": bmap_cuda.backward_map, "eig9": eig9_cuda.null_vector}


def empty_usage() -> dict:
    """A child's usage over a call before its first task (an entry of
    ``WorkerPool.last_usage``)."""
    return {"tasks": 0, "launches": {}, "cpu_seconds": 0.0, "peak_bytes": None,
            "peak_reserved_bytes": None, "graphs": (0, 0), "requests": []}


def _run_task(fn, args, env, record):
    """fn(*args) under the call's environment, recorded by the span
    recorder where `record`; (ok, result or traceback text, usage)."""
    for name in [n for n in os.environ if n.startswith("MESHFLOW_") and n not in env]:
        del os.environ[name]
    os.environ.update(env)
    wrappers = _wrappers()
    before = {name: w.launches for name, w in wrappers.items()}
    graphs_before = graphs.totals["captures"], graphs.totals["replays"]
    on_card = _DEVICE.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(_DEVICE)
    profiling.clear()
    cpu = time.process_time()
    try:
        with profiling.recording(record):
            result, ok = fn(*args), True
    except BaseException:  # raised again in the parent
        ok, result = False, traceback.format_exc()
    usage = {
        "launches": {n: w.launches - before[n] for n, w in wrappers.items()},
        "graphs": (graphs.totals["captures"] - graphs_before[0],
                   graphs.totals["replays"] - graphs_before[1]),
        "cpu_seconds": time.process_time() - cpu,
        "peak_bytes": torch.cuda.max_memory_allocated(_DEVICE) if on_card else None,
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(_DEVICE) if on_card else None,
        "requests": profiling.plain(profiling.requests()) if record else [],
    }
    profiling.clear()
    if on_card:
        # An idle worker holds no device memory.  cuBLAS keeps a workspace
        # for each stream it ran on, allocated and never freed, and each
        # job's graph runner warms up on a stream of its own: without this
        # a worker kept 32 MiB more after every job (H100 80GB HBM3).
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
    return ok, result, usage


def _child_main(device_name: str, threads: int, conn) -> None:
    """A worker process: run the tasks that come over `conn` until the
    parent sends None or goes away."""
    global _DEVICE
    signal.signal(signal.SIGINT, signal.SIG_IGN)  # the parent handles an interrupt
    torch.set_num_threads(threads)
    _DEVICE = torch.device(device_name)
    if _DEVICE.type == "cuda":
        torch.cuda.set_device(_DEVICE)
    import meshflow_tpu_torch.api  # noqa: F401  (the port, before the first task)

    conn.send("ready")
    try:
        while True:
            try:
                # `task` holds the last task's arguments while the next one
                # unpickles, so a shared buffer sent again is found mapped.
                task = conn.recv()
            except EOFError:
                break
            if task is None:
                break
            task_id, fn, args, env, record = task
            ok, result, usage = _run_task(fn, args, env, record)
            try:
                conn.send((task_id, ok, result, usage))
            except Exception:  # the result does not pickle: say so instead
                conn.send((task_id, False, traceback.format_exc(), usage))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _init_group(store_path: str, backend: str, rank: int, world: int) -> None:
    # Every rank is a child of one host: NCCL's bootstrap sockets stay on
    # the loopback interface unless the caller named another.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group(backend, store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)


class WorkerPool:
    """One spawned child for each entry of a device list (see the module
    docstring)."""

    def __init__(self, devices):
        global _POOL
        self.devices = [torch.device(d) for d in devices]
        self.backend = None
        self.last_usage = []
        self._store_dir = None
        self._buffers = {}
        self._slots = {}
        if any(d.type == "cuda" for d in self.devices):
            # Build and load the kernels once here: the children find the
            # cached library instead of each running nvcc.
            from meshflow_tpu_torch.kernels import _build

            _build.library()
        ctx = mp.get_context("spawn")
        threads = max(1, torch.get_num_threads() // len(self.devices))
        self.conns, self.procs = [], []
        with profiling.span("batch.pool_start"):
            for i, d in enumerate(self.devices):
                parent_end, child_end = ctx.Pipe()
                proc = ctx.Process(target=_child_main, args=(str(d), threads, child_end),
                                   name=f"meshflow-worker-{i}-{d}", daemon=True)
                proc.start()
                child_end.close()  # so that the child's exit shows as EOF here
                self.conns.append(parent_end)
                self.procs.append(proc)
            self._wait_ready()
        _POOL = self

    def _wait_ready(self) -> None:
        """Wait for every child's ready message; WorkerError (the pool
        closed) for a child that exits first."""
        waiting = set(range(len(self.procs)))
        while waiting:
            by_object = {self.conns[c]: c for c in waiting}
            by_object.update({self.procs[c].sentinel: c for c in waiting})
            for ready in connection.wait(list(by_object)):
                child = by_object[ready]
                if child not in waiting:
                    continue
                try:
                    self.conns[child].recv()
                except (EOFError, OSError):  # the child's end closed: it exited
                    self.procs[child].join(5)
                    self._fail(child, f"exited with code {self.procs[child].exitcode} "
                                      "before it was ready")
                waiting.discard(child)

    def shared(self, name: str, shape, dtype) -> torch.Tensor:
        """A CPU tensor in shared memory, kept by the pool for later calls
        that ask for the same name, shape and dtype (the one kept under
        `name` is dropped when they differ)."""
        key = (tuple(shape), dtype)
        found = self._buffers.get(name)
        if found is None or found[0] != key:
            self._buffers[name] = (key, shared_empty(shape, dtype))
        return self._buffers[name][1]

    def slots(self, shapes: dict) -> dict:
        """The slots of one call by name (`shapes`: name -> shape of uint8
        frames): each a view of the first ``shape[0]`` rows of the uint8
        tensor in shared memory that the pool keeps under that name.  The
        kept one serves when its rows have ``shape[1:]`` and it has at least
        ``shape[0]`` of them (span ``batch.slot:kept``), else a new one takes
        its place (span ``batch.slot:new``, around making it).  Slots of
        other names are dropped, and the children let go of every slot
        dropped or replaced before the call's tasks are sent."""
        def fits(name):
            found, shape = self._slots[name], tuple(shapes[name])
            return found.shape[1:] == shape[1:] and found.shape[0] >= shape[0]

        gone = [n for n in self._slots if n not in shapes or not fits(n)]
        for name in gone:
            del self._slots[name]
        if gone:
            self.each(_let_go, [(gone,)] * len(self.procs))
        out = {}
        for name, shape in shapes.items():
            with profiling.span("batch.slot", "kept" if name in self._slots else "new"):
                if name not in self._slots:
                    self._slots[name] = shared_empty(shape, torch.uint8)
                out[name] = self._slots[name][: shape[0]]
        return out

    # -- tasks ---------------------------------------------------------
    def map(self, fn, args_list) -> list:
        """fn(*args) for every args of `args_list`, each on whichever child
        is free; the results in list order."""
        args_list = [tuple(args) for args in args_list]
        todo, free, busy = list(range(len(args_list))), list(range(len(self.procs))), {}
        results = [None] * len(args_list)
        self._begin()
        while todo or busy:
            while todo and free:
                i, child = todo.pop(0), free.pop(0)
                self._send(child, i, fn, args_list[i])
                busy[child] = i
            child, i, result = self._receive(busy)
            results[i] = result
            free.append(child)
        return results

    def each(self, fn, args_by_child) -> list:
        """fn(*args_by_child[c]) on child c, all at once; results by child."""
        self._begin()
        busy = {}
        for child, args in enumerate(args_by_child):
            self._send(child, child, fn, tuple(args))
            busy[child] = child
        results = [None] * len(busy)
        while busy:
            _, i, result = self._receive(busy)
            results[i] = result
        return results

    def init_group(self) -> str:
        """A ``torch.distributed`` group over the children, rank = index,
        set up once (a file store in a fresh temporary directory); returns
        its backend."""
        if self.backend is None:
            backend = backend_for(self.devices)
            self._store_dir = tempfile.mkdtemp(prefix="meshflow-group-")
            store = os.path.join(self._store_dir, "store")
            world = len(self.devices)
            self.each(_init_group, [(store, backend, r, world) for r in range(world)])
            self.backend = backend
        return self.backend

    def _begin(self) -> None:
        self._env = {k: v for k, v in os.environ.items() if k.startswith("MESHFLOW_")}
        self._record = profiling.enabled()
        self.last_usage = [empty_usage() for _ in self.procs]

    def _send(self, child: int, task_id: int, fn, args) -> None:
        try:
            self.conns[child].send((task_id, fn, args, self._env, self._record))
        except OSError:
            self._fail(child, None)

    def _receive(self, busy: dict):
        """The next answer of a busy child: (child, task id, result);
        removes the child from `busy`.  Raises WorkerError for a child that
        raised or exited."""
        by_object = {self.conns[c]: c for c in busy}
        by_object.update({self.procs[c].sentinel: c for c in busy})
        while True:
            for ready in connection.wait(list(by_object)):
                child = by_object[ready]
                try:
                    task_id, ok, result, usage = self.conns[child].recv()
                except (EOFError, OSError):  # the child's end closed: it exited
                    self._fail(child, None)
                self._account(child, usage)
                if not ok:
                    self._fail(child, f"raised:\n{result}")
                del busy[child]
                return child, task_id, result

    def _account(self, child: int, usage: dict) -> None:
        wrappers = _wrappers()
        total = self.last_usage[child]
        total["tasks"] += 1
        total["cpu_seconds"] += usage["cpu_seconds"]
        total["graphs"] = tuple(a + b for a, b in zip(total["graphs"], usage["graphs"]))
        for name, n in usage["launches"].items():
            wrappers[name].launches += n
            total["launches"][name] = total["launches"].get(name, 0) + n
        for key in ("peak_bytes", "peak_reserved_bytes"):
            if usage[key] is not None:
                total[key] = max(total[key] or 0, usage[key])
        total["requests"].extend(usage["requests"])

    def _fail(self, child: int, what) -> None:
        proc = self.procs[child]
        if what is None:
            proc.join(5)
            what = f"exited with code {proc.exitcode}"
        self.close(terminate=True)
        raise WorkerError(f"worker {child} ({self.devices[child]}, pid {proc.pid}) {what}")

    # -- life ----------------------------------------------------------
    def close(self, terminate: bool = False) -> None:
        """Stop the children (at once with `terminate`, else after their
        current task) and forget the pool."""
        global _POOL
        if _POOL is self:
            _POOL = None
        self._buffers = {}
        self._slots = {}
        for conn, proc in zip(self.conns, self.procs):
            if not terminate and proc.is_alive():
                try:
                    conn.send(None)
                except OSError:  # it exited meanwhile
                    pass
        for proc in self.procs:
            if not terminate:
                proc.join(30)
            if proc.is_alive():
                proc.terminate()
                proc.join(10)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in self.conns:
            conn.close()
        self.conns, self.procs = [], []
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None


class Collectives:
    """One rank's side of the JAX package's ``shard_map`` collectives, over
    the default ``torch.distributed`` group (``world`` 1: no group, each
    collective the identity on the rank's own value).  Over gloo a device
    tensor goes through host memory for each collective."""

    def __init__(self, rank: int, world: int, device):
        self.rank, self.world, self.device = rank, world, torch.device(device)
        self.staged = world > 1 and dist.get_backend() == "gloo" and self.device.type != "cpu"

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.contiguous().cpu() if self.staged else t.contiguous()

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world, *t.shape): every rank's `t` in rank order."""
        if self.world == 1:
            return t[None]
        wire = self._wire(t.reshape(-1))
        parts = [torch.empty_like(wire) for _ in range(self.world)]
        dist.all_gather(parts, wire)
        return torch.stack(parts).reshape((self.world,) + t.shape).to(self.device)

    def ppermute(self, t: torch.Tensor, offset: int) -> torch.Tensor:
        """The `t` of rank (rank + offset) % world: the ``ppermute`` on a
        ring in which every rank sends to (rank - offset) % world."""
        if self.world == 1:
            return t
        wire = self._wire(t)
        got = torch.empty_like(wire)
        ops = [dist.P2POp(dist.isend, wire, (self.rank - offset) % self.world),
               dist.P2POp(dist.irecv, got, (self.rank + offset) % self.world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got.to(self.device)

    def halo(self, head: torch.Tensor, tail: torch.Tensor):
        """(the left neighbour's `tail`, the right neighbour's `head`), None
        past the first or the last rank: this rank's `head` goes left and
        its `tail` right, every send and receive in one batch."""
        if self.world == 1:
            return None, None
        ops, got = [], []
        for peer, send, like in ((self.rank - 1, head, tail), (self.rank + 1, tail, head)):
            if not 0 <= peer < self.world:
                got.append(None)
                continue
            got.append(torch.empty(like.shape, dtype=like.dtype,
                                   device="cpu" if self.staged else like.device))
            ops += [dist.P2POp(dist.isend, self._wire(send), peer),
                    dist.P2POp(dist.irecv, got[-1], peer)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(None if g is None else g.to(self.device) for g in got)
