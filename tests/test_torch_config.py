"""PyTorch port: configuration, geometry and the JAX-compatible PRNG.

The port's config must carry the JAX package's fields, defaults and
derived geometry; its threefry key tree must reproduce ``jax.random`` bit
for bit, because RANSAC draws are compared sample for sample; and the
package must import with JAX absent.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from meshflow_tpu.config import MeshFlowConfig as JaxConfig
from meshflow_tpu.kernels.homography import _sample_distinct4
from meshflow_tpu.utils import grid as jax_grid

from meshflow_tpu_torch import interop
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels.homography import sample_distinct4
from meshflow_tpu_torch.utils import grid, prng

REPO = Path(__file__).resolve().parents[1]

GEOMETRIES = [
    (360, 640, {}),
    (180, 320, dict(mesh_outlier_subframe_row_count=2, mesh_outlier_subframe_col_count=2)),
    (1080, 1920, dict(mesh_row_count=64, mesh_col_count=64)),
    (720, 1280, dict(track_downscale=0)),
    (2160, 3840, {}),
    (37, 53, dict(mesh_row_count=3, mesh_col_count=5, lk_max_level_cap=1)),
]


@pytest.mark.parametrize("h,w,fields", GEOMETRIES)
def test_config_and_geometry_match_jax(h, w, fields):
    jc = JaxConfig(**fields)
    tc = interop.config_from_fields(dataclasses.asdict(jc))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc == MeshFlowConfig(**fields)
    for name in ("resolve_track_downscale", "track_shape", "subframe_shape", "lk_max_level"):
        assert getattr(tc, name)(h, w) == getattr(jc, name)(h, w), name
    for name in ("vertex_rows", "vertex_cols", "num_vertices", "num_subframes",
                 "max_features_per_frame"):
        assert getattr(tc, name) == getattr(jc, name), name
    np.testing.assert_array_equal(
        grid.vertex_grid(tc, h, w).numpy(), jax_grid.vertex_grid(jc, h, w)
    )
    np.testing.assert_array_equal(
        grid.subframe_offsets(tc, h, w).numpy(), jax_grid.subframe_offsets(jc, h, w)
    )


def test_config_validation_matches_jax():
    from meshflow_tpu.config import validate_adaptive_weights_definition as jv

    from meshflow_tpu_torch.config import validate_adaptive_weights_definition as tv

    for bad in (dict(mesh_row_count=0), dict(temporal_smoothing_radius=0),
                dict(track_planes="rgb"), dict(track_downscale=-1)):
        with pytest.raises(ValueError):
            JaxConfig(**bad)
        with pytest.raises(ValueError):
            MeshFlowConfig(**bad)
    for variant in (0, 1, 2, 3):
        jv(variant)
        tv(variant)
    for variant in (-1, 4):
        with pytest.raises(ValueError) as je:
            jv(variant)
        with pytest.raises(ValueError) as te:
            tv(variant)
        assert str(je.value) == str(te.value)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_prng_key_tree_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    tkey = prng.PRNGKey(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(key))
    for d in (0, 1, 2, 63, 12345, 2**32 - 1):
        np.testing.assert_array_equal(
            prng.fold_in(tkey, d).numpy(), np.asarray(jax.random.fold_in(key, d))
        )
    # batched fold_in, then split per subframe
    folded = prng.fold_in(tkey, np.arange(5) + 7)
    for i in range(5):
        jk = jax.random.fold_in(key, 7 + i)
        np.testing.assert_array_equal(folded[i].numpy(), np.asarray(jk))
        np.testing.assert_array_equal(
            prng.split(folded[i], 16).numpy(), np.asarray(jax.random.split(jk, 16))
        )
    np.testing.assert_array_equal(
        interop.key_from_jax(np.asarray(key)).numpy(), tkey.numpy()
    )


@pytest.mark.parametrize("maxval", [1, 2, 3, 4, 7, 100, 511, 512, 65537])
def test_prng_randint_matches_jax(maxval):
    key = jax.random.fold_in(jax.random.PRNGKey(3), maxval)
    got = prng.randint(prng.key_data(np.asarray(key)), 256, 0, maxval).numpy()
    want = np.asarray(jax.random.randint(key, (256,), 0, jnp.maximum(maxval, 1)))
    np.testing.assert_array_equal(got, want)


def test_sample_distinct4_matches_jax():
    base = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    counts = [0, 1, 3, 4, 5, 17, 128, 512]
    keys = jax.random.split(base, len(counts))
    got = sample_distinct4(
        prng.key_data(np.asarray(keys)), 256, _as_tensor(counts)
    ).numpy()
    for i, m in enumerate(counts):
        want = np.asarray(_sample_distinct4(keys[i], 256, jnp.asarray(m, jnp.int32)))
        np.testing.assert_array_equal(got[i], want, err_msg=f"count {m}")
        if m >= 4:
            assert (np.sort(got[i], axis=1)[:, 1:] != np.sort(got[i], axis=1)[:, :-1]).all()
            assert got[i].max() < m


def _as_tensor(values):
    import torch

    return torch.tensor(values)


def test_port_imports_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['cv2'] = None\n"
        "import meshflow_tpu_torch, torch\n"
        "from meshflow_tpu_torch import api, interop\n"
        "from meshflow_tpu_torch.kernels import lk_cuda, bmap_cuda, lk_band_cuda, lk_fetch\n"
        "from meshflow_tpu_torch import online, cli, streaming, checkpoint\n"
        "from meshflow_tpu_torch.parallel import batch, pipeline, workers\n"
        "from meshflow_tpu_torch.motion import features, pipeline as motion_pipeline\n"
        "from meshflow_tpu_torch.render import stabilize\n"
        "from meshflow_tpu_torch.solver import jacobi\n"
        "from meshflow_tpu_torch.kernels import color, _launch\n"
        "from meshflow_tpu_torch.motion import trackscale\n"
        "from meshflow_tpu_torch.utils import profiling\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "assert torch.backends.cudnn.allow_tf32 is False\n"
        "assert meshflow_tpu_torch.MeshFlowStabilizer is api.MeshFlowStabilizer\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_default_device_is_the_card(monkeypatch):
    """No silent CPU fallback: without a card, the default device fails
    the way torch fails, and device="cpu" is the way to ask for the CPU."""
    import torch

    from meshflow_tpu_torch.api import MeshFlowStabilizer, default_device
    from meshflow_tpu_torch.online import OnlineMeshFlowStabilizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_device() == "cuda"
    if not torch.backends.cuda.is_built() or torch.cuda.device_count() == 0:
        with pytest.raises((RuntimeError, AssertionError)):
            MeshFlowStabilizer()
        with pytest.raises((RuntimeError, AssertionError)):
            OnlineMeshFlowStabilizer()
    assert MeshFlowStabilizer(device="cpu").device.type == "cpu"
    assert OnlineMeshFlowStabilizer(device="cpu").device.type == "cpu"


def test_compute_metrics_env(monkeypatch):
    from meshflow_tpu_torch.api import MeshFlowStabilizer

    for value, want in (("0", False), (" Off ", False), ("FALSE", False), ("1", True)):
        monkeypatch.setenv("MESHFLOW_COMPUTE_METRICS", value)
        assert MeshFlowStabilizer(device="cpu").config.compute_metrics is want
        assert MeshFlowStabilizer(device="cpu", compute_metrics=True).config.compute_metrics
    monkeypatch.delenv("MESHFLOW_COMPUTE_METRICS")
    assert MeshFlowStabilizer(device="cpu").config.compute_metrics


@pytest.mark.parametrize("env,kwargs,gray", [
    ({"MESHFLOW_TRACK_PLANES": "gray"}, {}, True),
    ({"MESHFLOW_TRACK_PLANES": "bgr"}, {}, False),
    ({"MESHFLOW_TRACK_PLANES": ""}, {}, False),
    ({"MESHFLOW_TRACK_PLANES": "gray"}, {"track_planes": "bgr"}, False),
    ({"MESHFLOW_CHECKPOINT_DIR": "TMP"}, {}, False),
    ({"MESHFLOW_CHECKPOINT_DIR": ""}, {}, False),
], ids=["planes-gray", "planes-bgr", "planes-empty", "argument-wins", "checkpoint",
        "checkpoint-empty"])
def test_track_planes_and_checkpoint_env(monkeypatch, tmp_path, env, kwargs, gray):
    """The port reads MESHFLOW_TRACK_PLANES and MESHFLOW_CHECKPOINT_DIR with
    the JAX constructor's priority (argument > environment > config) and
    keeps the same checkpoint directory; where JAX then tracks gray planes,
    the port builds the same gray config."""
    from meshflow_tpu.api import MeshFlowStabilizer as JaxStabilizer

    from meshflow_tpu_torch.api import MeshFlowStabilizer

    for name in ("MESHFLOW_TRACK_PLANES", "MESHFLOW_CHECKPOINT_DIR"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, str(tmp_path) if value == "TMP" else value)
    js = JaxStabilizer(**kwargs)
    assert (js.config.track_planes != "bgr") is gray
    ts = MeshFlowStabilizer(device="cpu", **kwargs)
    assert ts.config == interop.config_from_fields(dataclasses.asdict(js.config))
    assert (ts.config.track_planes == "gray") is gray
    assert ts.checkpoint_dir == js.checkpoint_dir
