"""PyTorch port: checkpoint/resume of the streaming pipeline's pass 1
(``meshflow_tpu_torch/checkpoint.py``), the port of
``tests/test_api_e2e.py::test_checkpoint_resume_identical``, and its keys
against the JAX package's.

Small shapes as in ``test_torch_streaming.py`` (SMALL config, CHUNK 4, 10
frames of 180x320).  Tolerance: a resumed run reads back the float32
arrays pass 1 saved, so its frames and metrics equal the fresh run's
exactly.
"""

import os

import numpy as np
import pytest

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu import checkpoint as jax_ckpt
from meshflow_tpu.config import MeshFlowConfig as JaxConfig
from meshflow_tpu.motion import pipeline as jax_pipeline

from meshflow_tpu_torch import checkpoint as ckpt, cli
from meshflow_tpu_torch.api import MeshFlowStabilizer
from meshflow_tpu_torch.config import MeshFlowConfig
from test_torch_slice import _clip
from test_torch_streaming import CHUNK, SMALL, _stabilizer, _streamed, _write_mjpg
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """A clip file, a checkpoint directory after one fresh run with it, and
    that run's (frames, metrics)."""
    tmp = tmp_path_factory.mktemp("ckpt")
    path = str(tmp / "in.avi")
    _write_mjpg(path, _clip(10, 180, 320, pan=12, seed=2))
    ckpt_dir = str(tmp / "checkpoints")
    result = _streamed(_stabilizer(checkpoint_dir=ckpt_dir), path)
    return path, ckpt_dir, result


def _no_pass1(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("pass 1 ran despite the checkpoint")

    monkeypatch.setattr(MeshFlowStabilizer, "_pass1", boom)


def test_resumed_run_equals_fresh(fresh, monkeypatch):
    path, ckpt_dir, (frames, metrics) = fresh
    assert len(os.listdir(ckpt_dir)) == 1
    _no_pass1(monkeypatch)
    got_frames, got_metrics = _streamed(_stabilizer(checkpoint_dir=ckpt_dir), path)
    np.testing.assert_array_equal(got_frames, frames)
    assert got_metrics == metrics


def test_other_variant_reuses_checkpoint(fresh, monkeypatch):
    path, ckpt_dir, _ = fresh
    want = _streamed(_stabilizer(), path, variant=2)  # no checkpoint
    _no_pass1(monkeypatch)
    got = _streamed(_stabilizer(checkpoint_dir=ckpt_dir), path, variant=2)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert len(os.listdir(ckpt_dir)) == 1


def test_stabilize_resumes_through_the_api(fresh, tmp_path, monkeypatch):
    """MESHFLOW_CHECKPOINT_DIR reaches the stream through ``stabilize``."""
    path, ckpt_dir, (_, metrics) = fresh
    _no_pass1(monkeypatch)
    monkeypatch.setenv("MESHFLOW_CHECKPOINT_DIR", ckpt_dir)
    monkeypatch.delenv("MESHFLOW_STREAM", raising=False)
    stab = MeshFlowStabilizer(config=MeshFlowConfig(**SMALL), device="cpu")
    stab.CHUNK = CHUNK
    assert stab.checkpoint_dir == ckpt_dir
    assert stab.stabilize(path, str(tmp_path / "out.avi"), 0) == metrics


def test_cli_passes_checkpoint_dir(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(MeshFlowStabilizer, "stabilize",
                        lambda self, *a: seen.append(self.checkpoint_dir) or (1.0, 1.0, 0.5))
    argv = ["in.avi", "out.avi", "--device", "cpu", "--checkpoint-dir", str(tmp_path)]
    assert cli.main(argv) == 0
    assert seen == [str(tmp_path)]


def test_tracker_keys_differ_from_each_other_and_from_jax(monkeypatch, tmp_path):
    """The card's kernels and the CPU's plain version get different keys,
    and no key of the port equals either of the JAX package's."""
    config, jconfig = MeshFlowConfig(**SMALL), JaxConfig(**SMALL)
    cuda, cpu = (ckpt._motion_config_key(config, d) for d in ("cuda", "cpu"))
    jax_keys = set()
    for pallas in (True, False):
        monkeypatch.setattr(jax_pipeline, "use_pallas_lk", lambda p=pallas: p)
        jax_keys.add(jax_ckpt._motion_config_key(jconfig))
    assert len(jax_keys) == 2 and cuda != cpu and not {cuda, cpu} & jax_keys
    clip = tmp_path / "clip.avi"
    clip.write_bytes(b"x")
    paths = {ckpt.cache_path(str(tmp_path), str(clip), config, 0, d) for d in ("cuda", "cpu")}
    monkeypatch.setattr(jax_pipeline, "use_pallas_lk", lambda: True)
    paths.add(jax_ckpt.cache_path(str(tmp_path), str(clip), jconfig, 0))
    assert len(paths) == 3
    assert ckpt.FORMAT_VERSION == jax_ckpt.FORMAT_VERSION
    assert ckpt.MotionCheckpoint._fields == jax_ckpt.MotionCheckpoint._fields


def test_checkpoint_of_another_length_is_ignored(fresh, tmp_path, monkeypatch):
    """A checkpoint at the clip's key whose arrays hold another frame count
    is recomputed, as the JAX package ignores it; so is a corrupt one."""
    path, ckpt_dir, (frames, metrics) = fresh
    stab = _stabilizer(checkpoint_dir=str(tmp_path))
    target = ckpt.cache_path(str(tmp_path), path, stab.config, int(stab._key[-1]), "cpu")
    good = ckpt.load_motion(os.path.join(ckpt_dir, os.listdir(ckpt_dir)[0]))
    ckpt.save_motion(target, ckpt.MotionCheckpoint(*(a[:-1] for a in good)))
    runs = []
    pass1 = MeshFlowStabilizer._pass1
    monkeypatch.setattr(MeshFlowStabilizer, "_pass1", lambda *a: runs.append(1) or pass1(*a))
    got = _streamed(stab, path)
    assert runs == [1]
    np.testing.assert_array_equal(got[0], frames)
    assert got[1] == metrics
    assert ckpt.load_motion(target).displacements.shape[0] == 10  # rewritten
    with open(target, "wb") as f:
        f.write(b"not an npz")
    assert ckpt.load_motion(target) is None


def test_checkpoint_of_an_earlier_revision_misses(fresh, tmp_path, monkeypatch):
    """A checkpoint written under tracker revision 1 (before the card's DLT
    took its null vector from the eig9 kernel) is not found under revision
    2, on either tracker: pass 1 runs again and writes an r2 checkpoint."""
    path, ckpt_dir, (frames, metrics) = fresh
    assert ckpt.LK_KERNEL_REVISION == 2
    stab = _stabilizer(checkpoint_dir=str(tmp_path))
    seed = int(stab._key[-1])
    with monkeypatch.context() as m:
        m.setattr(ckpt, "LK_KERNEL_REVISION", 1)
        old = {d: ckpt.cache_path(str(tmp_path), path, stab.config, seed, d)
               for d in ("cuda", "cpu")}
        assert "torch-plain-r1" in ckpt._motion_config_key(stab.config, "cpu")
    new = {d: ckpt.cache_path(str(tmp_path), path, stab.config, seed, d)
           for d in ("cuda", "cpu")}
    assert not set(old.values()) & set(new.values())
    good = ckpt.load_motion(os.path.join(ckpt_dir, os.listdir(ckpt_dir)[0]))
    ckpt.save_motion(old["cpu"], good)
    runs = []
    pass1 = MeshFlowStabilizer._pass1
    monkeypatch.setattr(MeshFlowStabilizer, "_pass1", lambda *a: runs.append(1) or pass1(*a))
    got = _streamed(stab, path)
    assert runs == [1]
    np.testing.assert_array_equal(got[0], frames)
    assert got[1] == metrics
    assert ckpt.load_motion(new["cpu"]) is not None
