"""PyTorch port: the whole in-memory, device-render slice against the JAX
package's ``_stabilize_frames`` (MESHFLOW_RENDER=device), and the file
route ``stabilize(in, out)``.

Tolerances: keypoints and the crop rectangle are exact; everything
downstream carries the LK endpoints' float32 round-off (test_torch_lk.py)
through RANSAC, the medians and the solver, so stabilized displacements
agree within 0.05 px, cropped frames at PSNR >= 40 dB, stability within
1e-3 relative, and the cropping ratio and distortion (RANSAC-fitted
homographies of the metric pass) within 1e-2 relative.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu.api import MeshFlowStabilizer as JaxStabilizer
from meshflow_tpu.config import MeshFlowConfig as JaxConfig
from meshflow_tpu.motion import pipeline as jpipe
from meshflow_tpu.render import stabilize as jrender
from meshflow_tpu.solver.jacobi import jacobi_smooth as jjacobi
from meshflow_tpu.solver.weights import adaptive_weights as jweights
from meshflow_tpu.utils import grid as jgrid

from meshflow_tpu_torch.api import MeshFlowStabilizer
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.motion import pipeline as tpipe
from meshflow_tpu_torch.solver.jacobi import jacobi_smooth
from meshflow_tpu_torch.solver.weights import adaptive_weights
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)


TINY = dict(
    mesh_row_count=8,
    mesh_col_count=8,
    mesh_outlier_subframe_row_count=2,
    mesh_outlier_subframe_col_count=2,
    max_features_per_subframe=128,
)


def _clip(num_frames, h, w, pan, seed=0):
    """Seeded BGR clip: integer-shift crops of a blurred-noise canvas, a
    smooth pan to the right plus +-3 px jitter."""
    rng = np.random.default_rng(seed)
    margin = 40
    small = rng.integers(0, 256, ((h + 2 * margin) // 4 + 1, (w + pan + 2 * margin) // 4 + 1, 3))
    canvas = np.repeat(np.repeat(small, 4, 0), 4, 1).astype(np.float32)
    canvas = cv2.GaussianBlur(canvas, (5, 5), 1.0)
    canvas = np.round(canvas).astype(np.uint8)
    frames = []
    for t in range(num_frames):
        jx, jy = rng.integers(-3, 4, 2)
        x0 = margin + int(round(pan * t / max(num_frames - 1, 1))) + jx
        frames.append(canvas[margin + jy : margin + jy + h, x0 : x0 + w])
    return np.stack(frames)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0**2 / mse)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def _compare_slice(monkeypatch, fields, num_frames, h, w, variant):
    monkeypatch.setenv("MESHFLOW_RENDER", "device")
    frames = _clip(num_frames, h, w, pan=12)
    jc, tc = JaxConfig(**fields), MeshFlowConfig(**fields)
    js = JaxStabilizer(config=jc)
    jcrop_frames, jratio, jdist, jstab = js._stabilize_frames(
        jnp.asarray(frames), variant, h, w
    )
    ts = MeshFlowStabilizer(config=tc, device="cpu")
    cropped, ratio, dist, stab = ts._stabilize_frames(torch.from_numpy(frames), variant)

    # stage by stage: keypoints, solved displacements, crop
    jk, _ = jpipe.prepare_frames(jnp.asarray(frames), jc)
    tk, _ = tpipe.prepare_frames(torch.from_numpy(frames), tc)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    chunk = min(JaxStabilizer.CHUNK, num_frames)
    jm = jpipe.estimate_motion_chunked(
        jk, jnp.asarray(frames), jax.random.fold_in(js._key, 1), jc, h, w,
        chunk_pairs=max(chunk - 1, 1),
    )
    lam = jweights(jm.homographies, w, h, variant)
    jds = jjacobi(jm.displacements, lam, jc.temporal_smoothing_radius,
                  jc.optimization_num_iterations)
    tm = ts.last_motion
    tds = jacobi_smooth(
        tm.displacements, adaptive_weights(tm.homographies, w, h, variant),
        tc.temporal_smoothing_radius, tc.optimization_num_iterations,
    )
    assert np.abs(tds.numpy() - np.asarray(jds)).max() <= 0.05
    grid = jnp.asarray(jgrid.vertex_grid(jc, h, w))
    crops = []
    for start in range(0, num_frames, chunk):
        sl = slice(start, start + chunk)
        _, c = jrender.render_stabilized(
            jnp.asarray(frames[sl]), jm.displacements[sl], jds[sl], grid, jc, h, w
        )
        crops.append(np.asarray(c))
    crops = np.stack(crops)
    jcrop = [crops[:, 0].max(), crops[:, 1].max(), crops[:, 2].min(), crops[:, 3].min()]
    assert ts.last_crop.tolist() == [int(v) for v in jcrop]

    assert cropped.shape == (num_frames, h, w, 3) and cropped.dtype == torch.uint8
    assert _psnr(cropped.numpy(), np.asarray(jcrop_frames)) >= 40.0
    assert _rel(stab, jstab) <= 1e-3
    assert _rel(ratio, jratio) <= 1e-2
    assert _rel(dist, jdist) <= 1e-2


def test_slice_matches_jax_tiny(monkeypatch):
    _compare_slice(monkeypatch, TINY, num_frames=12, h=180, w=320, variant=0)


@pytest.mark.slow
def test_slice_matches_jax_default_640x360(monkeypatch):
    _compare_slice(monkeypatch, {}, num_frames=24, h=360, w=640, variant=0)


def test_stabilize_file_route(tmp_path):
    frames = _clip(10, 180, 320, pan=10, seed=1)
    src = str(tmp_path / "in.avi")
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 24.0, (320, 180))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()
    decoded = []
    cap = cv2.VideoCapture(src)
    while True:
        ok, f = cap.read()
        if not ok:
            break
        decoded.append(f)
    cap.release()

    stab = MeshFlowStabilizer(config=MeshFlowConfig(**TINY), device="cpu")
    out = str(tmp_path / "out.avi")
    metrics = stab.stabilize(src, out, MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED)
    assert len(metrics) == 3 and all(np.isfinite(metrics))
    cropped, *expected = stab._stabilize_frames(
        torch.from_numpy(np.stack(decoded)),
        MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED,
    )
    assert metrics == tuple(float(x) for x in expected)
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(decoded)
    assert cap.get(cv2.CAP_PROP_FPS) == pytest.approx(24.0)
    cap.release()

    with pytest.raises(ValueError):
        stab.stabilize(src, out, 7)
    with pytest.raises(IOError):
        stab.stabilize(os.path.join(str(tmp_path), "missing.avi"), out)
