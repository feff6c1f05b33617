"""PyTorch port: the frame-sharded path and multi-clip batching
(``meshflow_tpu_torch/parallel/``) against the JAX package's
``meshflow_tpu/parallel/`` on the CPU.

The port runs a shard or a batch worker in a spawned process of its own
for each entry of its device list (here every entry is the CPU, and the
sharded path's group is gloo); one entry runs in the test's process.
Every test that spawns has a time limit of its own (``time_limit``), so
that a hung child fails one test.  Tolerances:

* the halo Jacobi solve adds its taps in the replicated solve's order, so
  it is ``torch.equal`` to it, alone and inside the pipeline;
* against JAX's ``stabilize_sharded`` (a 2-device CPU mesh,
  ``tests/test_sharding_smoke.py``'s geometry): the crop is equal, the
  frames agree at PSNR >= 40 dB and the metrics within
  ``test_torch_slice``'s ``_compare_slice`` gates (stability 1e-3
  relative, cropping ratio and distortion 1e-2), the LK endpoints'
  float32 round-off carried through RANSAC and the solve;
* 1 against 4 shards, JAX's own gates (``tests/test_sharding.py``): crop
  equal, metrics within 1e-3 relative, frames <= 1 LSB apart on > 99.9%
  of pixels (the prefix sum adds in another order);
* serving mode: the same pixels and crop, NaN cropping ratio and
  distortion, the same stability;
* a batch equals solo runs of its clips exactly.
"""

import contextlib
import json
import operator
import os
import signal

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu.config import MeshFlowConfig as JaxConfig
from meshflow_tpu.parallel.pipeline import frame_sharding, make_mesh
from meshflow_tpu.parallel.pipeline import stabilize_sharded as jax_sharded

from meshflow_tpu_torch.api import MeshFlowStabilizer
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.io import video as video_io
from meshflow_tpu_torch.kernels import bmap_cuda, lk_cuda
from meshflow_tpu_torch.parallel import batch, cuda_devices, workers
from meshflow_tpu_torch.parallel.pipeline import smooth_sharded, stabilize_sharded
from meshflow_tpu_torch.solver.jacobi import jacobi_smooth, jacobi_smooth_halo
from meshflow_tpu_torch.utils import prng
from test_torch_slice import _psnr, _rel
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)

# tests/test_sharding_smoke.py's truncated configuration and geometry
SMALL = dict(max_features_per_subframe=64, ransac_iterations=64, lk_max_iterations=10,
             optimization_num_iterations=20)
H, W = 96, 128
CPUS = [torch.device("cpu")] * 2


@contextlib.contextmanager
def time_limit(seconds):
    """Raise TimeoutError in the test, and end every worker process, when
    the block runs past `seconds`."""
    def expire(signum, frame):
        workers.shutdown(terminate=True)
        raise TimeoutError(f"worker processes still running after {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, previous)


@pytest.fixture(autouse=True, scope="module")
def close_pools():
    """No worker process outlives the module."""
    yield
    workers.shutdown()


def _frames(num_frames, seed=1234):
    """tests/test_sharding_smoke.py's clip: crops of a box-blurred noise
    canvas on a smooth sinusoidal path, gray replicated to BGR."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(H // 4 + 8, W // 4 + 8), dtype=np.uint8)
    canvas = np.kron(base, np.ones((4, 4), np.uint8)).astype(np.float32)
    for axis in (0, 1):
        canvas = 0.25 * np.roll(canvas, 1, axis) + 0.5 * canvas + 0.25 * np.roll(canvas, -1, axis)
    canvas = canvas.astype(np.uint8)
    frames = []
    for t in range(num_frames):
        dy = int(round(4 + 2 * np.sin(0.7 * t)))
        dx = int(round(6 + 3 * np.sin(0.4 * t + 1.0)))
        frames.append(canvas[dy : dy + H, dx : dx + W])
    return np.repeat(np.stack(frames)[..., None], 3, axis=-1)


def _run(frames, shards, solver_mode="halo", seed=0, **fields):
    out = stabilize_sharded(
        torch.from_numpy(frames), prng.PRNGKey(seed), MeshFlowConfig(**SMALL, **fields), H, W,
        devices=["cpu"] * shards, solver_mode=solver_mode,
    )
    return (out[0].numpy(), out[1].tolist()) + tuple(float(x) for x in out[2:])


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_halo_jacobi_equals_replicated(shards):
    """The halo solve of the sharded state, one process a shard, bit for
    bit the replicated one (omega 10, 12-frame shards, the boundary shards
    zero-padded)."""
    rng = np.random.default_rng(7)
    num_frames = 12 * shards
    b = torch.from_numpy(rng.normal(0, 5, (num_frames, 5, 6, 2)).astype(np.float32))
    lambdas = torch.from_numpy(rng.uniform(0.5, 30, num_frames).astype(np.float32))
    want = jacobi_smooth(b, lambdas, 10, 40)
    with time_limit(120):
        got = smooth_sharded(b, lambdas, 10, 40, devices=["cpu"] * shards)
    assert torch.equal(got, want)
    if shards > 1:
        with pytest.raises(ValueError):
            smooth_sharded(b, lambdas, 10, 40, devices=["cpu"] * shards * 2)


def test_halo_jacobi_exchanges_over_a_gloo_group():
    """jacobi_smooth_halo over a two-process gloo group: each rank takes
    its neighbour's omega frames every sweep, and the whole equals
    jacobi_smooth; the blocks solved apart, with no exchange, do not."""
    rng = np.random.default_rng(8)
    b = torch.from_numpy(rng.normal(0, 5, (16, 3, 4, 2)).astype(np.float32))
    lambdas = torch.from_numpy(rng.uniform(0.5, 30, 16).astype(np.float32))
    want = jacobi_smooth(b, lambdas, 5, 30)
    with time_limit(120):
        got = smooth_sharded(b, lambdas, 5, 30, devices=CPUS)
        assert workers.pool(CPUS).backend == "gloo"
    assert torch.equal(got, want)
    apart = torch.cat([jacobi_smooth(b[:8], lambdas[:8], 5, 30),
                       jacobi_smooth(b[8:], lambdas[8:], 5, 30)])
    assert not torch.equal(apart, want)


@pytest.fixture(scope="module")
def jax_two_shards():
    frames = _frames(24)
    mesh = make_mesh(jax.devices("cpu")[:2])
    sharded = jax.device_put(jnp.asarray(frames), frame_sharding(mesh))
    out = jax_sharded(sharded, jax.random.PRNGKey(0), JaxConfig(**SMALL), H, W, mesh)
    return frames, (np.asarray(out[0]), np.asarray(out[1]).tolist()) + tuple(
        float(x) for x in out[2:])


@pytest.fixture(scope="module")
def port_two_shards(jax_two_shards):
    with time_limit(300):
        return _run(jax_two_shards[0], 2)


def test_sharded_matches_jax(jax_two_shards, port_two_shards):
    _, (jcropped, jcrop, jratio, jdist, jstab) = jax_two_shards
    cropped, crop, ratio, dist, stab = port_two_shards
    assert cropped.shape == (24, H, W, 3) and cropped.dtype == np.uint8
    assert crop == jcrop
    assert _psnr(cropped, jcropped) >= 40.0
    assert _rel(stab, jstab) <= 1e-3
    assert _rel(ratio, jratio) <= 1e-2
    assert _rel(dist, jdist) <= 1e-2


def test_sharded_serving_mode(jax_two_shards, port_two_shards):
    with time_limit(300):
        served = _run(jax_two_shards[0], 2, compute_metrics=False)
    np.testing.assert_array_equal(served[0], port_two_shards[0])
    assert served[1] == port_two_shards[1]
    assert np.isnan(served[2]) and np.isnan(served[3])
    assert served[4] == port_two_shards[4]


@pytest.fixture(scope="module")
def shard_runs():
    """24 frames, 1 shard and 4 shards of 6, with omega 5 (a shard at least
    omega long, so the halo solver engages), both solver modes at 4."""
    frames = _frames(24, seed=5)
    with time_limit(400):
        return {
            1: _run(frames, 1, seed=5, temporal_smoothing_radius=5),
            4: _run(frames, 4, seed=5, temporal_smoothing_radius=5),
            "4-replicated": _run(frames, 4, "replicated", seed=5,
                                 temporal_smoothing_radius=5),
        }


def test_sharded_shard_count_invariance(shard_runs):
    c1, crop1, *m1 = shard_runs[1]
    c4, crop4, *m4 = shard_runs[4]
    assert crop1 == crop4
    np.testing.assert_allclose(m1, m4, rtol=1e-3)
    diff = np.abs(c1.astype(int) - c4.astype(int))
    assert (diff <= 1).mean() > 0.999


def test_sharded_halo_equals_replicated(shard_runs):
    halo, rep = shard_runs[4], shard_runs["4-replicated"]
    np.testing.assert_array_equal(halo[0], rep[0])
    assert halo[1:] == rep[1:]


def test_entry_points_need_a_card_without_devices(monkeypatch):
    """No CPU fallback: with no device list and no CUDA device, both entry
    points raise."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_devices()
    frames = torch.zeros((4, H, W, 3), dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stabilize_sharded(frames, prng.PRNGKey(0), MeshFlowConfig(), H, W)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.stabilize_batch([batch.BatchJob("in.avi", "out.avi")])
    with pytest.raises(ValueError, match="do not split"):
        stabilize_sharded(frames[:3], prng.PRNGKey(0), MeshFlowConfig(), H, W,
                          devices=["cpu", "cpu"])


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two cv2-written 12-frame MJPG clips of two seeds."""
    tmp = tmp_path_factory.mktemp("batch")
    paths = []
    for i in range(2):
        path = tmp / f"clip{i}.avi"
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30.0, (W, H))
        assert writer.isOpened()
        for f in _frames(12, seed=40 + i):
            writer.write(f)
        writer.release()
        paths.append(str(path))
    return tmp, paths


def test_batch_equals_solo(clips):
    tmp, paths = clips
    config = MeshFlowConfig(**SMALL)
    solo = [
        MeshFlowStabilizer(config=config, device="cpu").stabilize(p, str(tmp / f"solo{i}.avi"), 0)
        for i, p in enumerate(paths)
    ]
    jobs = [batch.BatchJob(p, str(tmp / f"batch{i}.avi"), 0) for i, p in enumerate(paths)]
    with time_limit(300):
        assert batch.stabilize_batch(jobs, config=config, devices=["cpu", "cpu"]) == tuple(solo)
    for i in range(2):
        a, _ = video_io.read_video(str(tmp / f"solo{i}.avi"))
        b, _ = video_io.read_video(str(tmp / f"batch{i}.avi"))
        np.testing.assert_array_equal(a, b)


def test_batch_manifest_cli(clips, capsys, monkeypatch):
    """``python -m meshflow_tpu_torch.parallel.batch manifest.json``: one
    JSON line per job in manifest order, each the job's solo result."""
    tmp, paths = clips
    manifest = tmp / "manifest.json"
    outs = [str(tmp / f"cli{i}.avi") for i in range(2)]
    variants = ["original", "constant-low"]
    manifest.write_text(json.dumps(
        [{"input": p, "output": o, "variant": v} for p, o, v in zip(paths, outs, variants)]))
    monkeypatch.setattr(batch, "stabilize_batch", _small_batch(batch.stabilize_batch, SMALL))
    with time_limit(300):
        assert batch.main([str(manifest), "--devices", "cpu,cpu", "--seed", "3"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [(x["input"], x["output"]) for x in lines] == list(zip(paths, outs))
    for path, line, variant in zip(paths, lines, (0, 3)):
        want = MeshFlowStabilizer(config=MeshFlowConfig(**SMALL), seed=3, device="cpu").stabilize(
            path, str(tmp / "want.avi"), variant)
        assert (line["cropping_ratio"], line["distortion_score"], line["stability_score"]) == want


def _small_batch(run, fields):
    """stabilize_batch with the small configuration in place of the
    default, so the CLI test stays quick; everything else is the CLI's."""
    def small(jobs, config=None, devices=None, seed=0):
        assert config is None
        return run(jobs, config=MeshFlowConfig(**fields), devices=devices, seed=seed)

    return small


# Run in a worker: its pid and the modules of the JAX package it holds.
CHILD_STATE = ("(__import__('os').getpid(), sorted(m for m in __import__('sys').modules "
               "if m.split('.')[0] in ('jax', 'meshflow_tpu')))")


def test_workers_are_processes_of_their_own():
    """A two-shard halo solve runs in two worker processes, one task each:
    their pids differ from the test's and from each other's, and neither
    holds JAX or the JAX package."""
    rng = np.random.default_rng(9)
    b = torch.from_numpy(rng.normal(0, 5, (12, 3, 4, 2)).astype(np.float32))
    lambdas = torch.from_numpy(rng.uniform(0.5, 30, 12).astype(np.float32))
    with time_limit(120):
        smooth_sharded(b, lambdas, 5, 10, devices=CPUS)
        pool = workers.pool(CPUS)
        assert [u["tasks"] for u in pool.last_usage] == [1, 1]
        assert all(u["cpu_seconds"] > 0 for u in pool.last_usage)
        states = pool.each(eval, [(CHILD_STATE,)] * 2)
    pids = [pid for pid, _ in states]
    assert pids == [p.pid for p in pool.procs]
    assert len(set(pids)) == 2 and os.getpid() not in pids
    assert [mods for _, mods in states] == [[], []]


def test_pool_keeps_its_buffers_and_one_pool_lives():
    """Two sharded calls of one shape share the pool's host buffers, yet
    the first call's result is its own (a copy, not the buffer); a batch
    call between them takes slots of its own and leaves the buffers as
    they were; a pool of another list closes the last one."""
    from meshflow_tpu_torch import streaming

    rng = np.random.default_rng(10)
    lambdas = torch.from_numpy(rng.uniform(0.5, 30, 12).astype(np.float32))
    bs = [torch.from_numpy(rng.normal(0, 5, (12, 3, 4, 2)).astype(np.float32)) for _ in range(2)]
    jobs = [batch.BatchJob(streaming.ArrayClip(_frames(8, seed=70 + i)), streaming.CaptureWriter(),
                           0) for i in range(2)]
    with time_limit(300):
        first = smooth_sharded(bs[0], lambdas, 5, 10, devices=CPUS)
        pool = workers.pool(CPUS)
        buffers = {name: t.data_ptr() for name, (_, t) in pool._buffers.items()}
        batch.stabilize_batch(jobs, config=MeshFlowConfig(**SMALL), devices=CPUS)
        assert workers.pool(CPUS) is pool and len(pool._slots) == 4
        assert {name: t.data_ptr() for name, (_, t) in pool._buffers.items()} == buffers
        second = smooth_sharded(bs[1], lambdas, 5, 10, devices=CPUS)
        assert workers.pool(CPUS) is pool
        assert {name: t.data_ptr() for name, (_, t) in pool._buffers.items()} == buffers
        procs = list(pool.procs)
        other = workers.pool([torch.device("cpu")] * 3)
    assert torch.equal(first, jacobi_smooth(bs[0], lambdas, 5, 10))
    assert torch.equal(second, jacobi_smooth(bs[1], lambdas, 5, 10))
    assert other is not pool and not any(p.is_alive() for p in procs)
    assert len(other.procs) == 3


class _Rank:
    """A rank's collectives with no group: a world-2 stand-in for the halo
    solver's own guard, which raises before any exchange."""

    def __init__(self, rank, world):
        self.rank, self.world = rank, world

    def halo(self, head, tail):
        raise AssertionError("no exchange expected")


def test_halo_jacobi_needs_blocks_of_omega():
    """jacobi_smooth_halo itself refuses blocks shorter than omega when
    there is more than one rank, before any exchange."""
    rng = np.random.default_rng(11)
    b = torch.from_numpy(rng.normal(0, 5, (8, 3, 4, 2)).astype(np.float32))
    lambdas = torch.from_numpy(rng.uniform(0.5, 30, 8).astype(np.float32))
    with pytest.raises(ValueError, match="omega=5"):
        jacobi_smooth_halo(b[:4], lambdas, 5, 10, _Rank(0, 2))


def test_batch_jobs_run_in_worker_processes(tmp_path):
    """stabilize_batch over two entries: each job on its own worker, the
    ArrayClip's frames through shared memory, the CaptureWriter filled in
    the caller's object, equal to the solo runs."""
    from meshflow_tpu_torch import streaming

    config = MeshFlowConfig(**SMALL)
    clips = [_frames(8, seed=60 + i) for i in range(2)]
    solo = []
    for frames in clips:
        writer = streaming.CaptureWriter()
        metrics = MeshFlowStabilizer(config=config, device="cpu").stabilize(
            streaming.ArrayClip(frames), writer, 0)
        solo.append((writer.frames(), metrics))
    jobs = [batch.BatchJob(streaming.ArrayClip(f), streaming.CaptureWriter(), 0) for f in clips]
    with time_limit(300):
        got = batch.stabilize_batch(jobs, config=config, devices=CPUS)
        usage = workers.pool(CPUS).last_usage
    assert [u["tasks"] for u in usage] == [1, 1]
    for job, metrics, (frames, want) in zip(jobs, got, solo):
        assert metrics == want
        np.testing.assert_array_equal(job.output_path.frames(), frames)


def test_child_launches_reach_the_parents_counters(monkeypatch):
    """The children's launch deltas are added into the parent's wrappers:
    each child sets its own kernel A and B counters (a stub for the CPU,
    where the wrappers take their plain versions and count nothing)."""
    devices = [torch.device("cpu")] * 3
    monkeypatch.setattr(lk_cuda.lk_level, "launches", 10)
    monkeypatch.setattr(bmap_cuda.backward_map, "launches", 1)
    with time_limit(60):
        pool = workers.pool(devices)
        pool.each(setattr, [(lk_cuda.lk_level, "launches", n) for n in (2, 3, 4)])
        pool.map(setattr, [(bmap_cuda.backward_map, "launches", 5)])
        pool.close()
    assert lk_cuda.lk_level.launches == 10 + 2 + 3 + 4
    assert bmap_cuda.backward_map.launches == 1 + 5
    assert [u["launches"].get("backward_map", 0) for u in pool.last_usage] == [5, 0, 0]


def test_a_child_that_raises_makes_the_call_raise():
    with time_limit(60):
        pool = workers.pool(CPUS)
        procs = list(pool.procs)
        with pytest.raises(workers.WorkerError, match="ZeroDivisionError: division by zero"):
            pool.map(operator.truediv, [(1, 2), (1, 0)])
        assert not any(p.is_alive() for p in procs)
        assert workers.pool(CPUS).map(operator.truediv, [(1, 2)]) == [0.5]


def test_a_child_that_exits_makes_the_call_raise():
    """A worker that exits mid-call raises in the parent with its exit
    code instead of leaving the parent waiting; the pool is closed."""
    with time_limit(60):
        pool = workers.pool(CPUS)
        procs = list(pool.procs)
        with pytest.raises(workers.WorkerError, match="exited with code 3"):
            pool.map(os._exit, [(3,)])
        assert not any(p.is_alive() for p in procs)
        assert workers.pool(CPUS) is not pool
