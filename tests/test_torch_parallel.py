"""PyTorch port: the frame-sharded path and multi-clip batching
(``meshflow_tpu_torch/parallel/``) against the JAX package's
``meshflow_tpu/parallel/`` on the CPU.

The port runs its shards over a list of torch devices in one process;
here every shard is the CPU.  Tolerances:

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

import json

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
from meshflow_tpu_torch.parallel import batch, cuda_devices
from meshflow_tpu_torch.parallel.pipeline import stabilize_sharded
from meshflow_tpu_torch.solver.jacobi import jacobi_smooth, jacobi_smooth_sharded
from meshflow_tpu_torch.utils import prng
from test_torch_slice import _psnr, _rel
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)

# tests/test_sharding_smoke.py's truncated configuration and geometry
SMALL = dict(max_features_per_subframe=64, ransac_iterations=64, lk_max_iterations=10,
             optimization_num_iterations=20)
H, W = 96, 128


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
    """The halo solve of the sharded state, bit for bit the replicated one
    (omega 10, 12-frame shards, the boundary shards zero-padded)."""
    rng = np.random.default_rng(7)
    num_frames = 12 * shards
    b = torch.from_numpy(rng.normal(0, 5, (num_frames, 5, 6, 2)).astype(np.float32))
    lambdas = torch.from_numpy(rng.uniform(0.5, 30, num_frames).astype(np.float32))
    want = jacobi_smooth(b, lambdas, 10, 40)
    got = jacobi_smooth_sharded(list(b.split(12)), lambdas, 10, 40)
    assert len(got) == shards
    assert torch.equal(torch.cat(got), want)
    if shards > 1:
        with pytest.raises(ValueError):
            jacobi_smooth_sharded(list(b.split(6)), lambdas, 10, 40)


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
    return {
        1: _run(frames, 1, seed=5, temporal_smoothing_radius=5),
        4: _run(frames, 4, seed=5, temporal_smoothing_radius=5),
        "4-replicated": _run(frames, 4, "replicated", seed=5, temporal_smoothing_radius=5),
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
