"""PyTorch port: track geometry (``meshflow_tpu_torch/motion/trackscale.py``)
against the JAX package's, and the slice at ``track_downscale=2`` against
JAX ``_stabilize_frames`` (MESHFLOW_RENDER=device) through
``compare_track_slice``, which tests/test_torch_geometry.py runs at the
other clip geometries.

Tolerances: the box downscale is integer arithmetic and must be bit-equal
to JAX and to cv2; velocity scaling and homography conjugation are one
float32 product or quotient per element, within 1e-6 relative.  The slice
gates are those of tests/test_torch_slice.py: keypoints and crop exact,
stabilized displacements within 0.05 px, PSNR >= 40 dB, stability within
1e-3 relative, cropping ratio and distortion within 1e-2 relative.
"""

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
from meshflow_tpu.motion import trackscale as jts
from meshflow_tpu.render import stabilize as jrender
from meshflow_tpu.solver.jacobi import jacobi_smooth as jjacobi
from meshflow_tpu.solver.weights import adaptive_weights as jweights
from meshflow_tpu.utils import grid as jgrid

from meshflow_tpu_torch.api import MeshFlowStabilizer
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels.color import bgr_to_gray
from meshflow_tpu_torch.motion import pipeline as tpipe
from meshflow_tpu_torch.motion import trackscale
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


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6])
def test_box_downscale_matches_jax_and_cv2(d):
    # 97x131 divides by no factor, so the alignment crop is exercised; d=2,
    # 3, 5 are what the auto policy picks, 4 and 6 the even >= 4 tie rule.
    frames = np.random.default_rng(d).integers(0, 256, (2, 97, 131, 3), dtype=np.uint8)
    got = trackscale.box_downscale_dev(torch.from_numpy(frames), d).numpy()
    np.testing.assert_array_equal(got, np.asarray(jts.box_downscale_dev(jnp.asarray(frames), d)))
    np.testing.assert_array_equal(got, jts.box_downscale_host(frames, d))
    np.testing.assert_array_equal(got, trackscale.box_downscale_host(frames, d))
    assert got.shape == (2, 97 // d, 131 // d, 3)


def test_box_downscale_tie_case():
    # a 2x2 block of {0, 1} averages to 0.5: the d=2 tie rule head-on
    tie = np.array([[[0, 1], [1, 0]]], np.uint8).reshape(1, 2, 2, 1)
    got = trackscale.box_downscale_dev(torch.from_numpy(tie), 2).numpy()
    np.testing.assert_array_equal(got, trackscale.box_downscale_host(tie, 2))
    np.testing.assert_array_equal(got, np.asarray(jts.box_downscale_dev(jnp.asarray(tie), 2)))
    # even d >= 4 rounds half to even: blocks averaging 2.5 and 3.5
    for value in (2, 3):
        block = np.full((1, 4, 4, 1), value, np.uint8)
        block[0, :2] += 1
        got = trackscale.box_downscale_dev(torch.from_numpy(block), 4).numpy()
        np.testing.assert_array_equal(got, trackscale.box_downscale_host(block, 4))


def test_box_downscale_working_set_is_bounded():
    """4K frames at d=5 (the factor 3840x2160 resolves to) are downscaled
    in blocks whose int32 copy holds at most _BLOCK_TEXELS values, and the
    sums stay int32: no op allocates more.  Summing a whole 64-frame block
    with the default integer promotion to int64 took 19.2 GB on the card
    (a 4K block's peak device memory).  The result equals cv2's."""
    from torch.profiler import ProfilerActivity, profile

    frames = np.random.default_rng(5).integers(0, 256, (6, 2160, 3840, 3), dtype=np.uint8)
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        got = trackscale.box_downscale_dev(torch.from_numpy(frames), 5)
    largest = max(e.cpu_memory_usage for e in prof.events())
    assert largest <= 4 * trackscale._BLOCK_TEXELS, largest
    assert got.shape == (6, 432, 768, 3)
    np.testing.assert_array_equal(got.numpy(), trackscale.box_downscale_host(frames, 5))


def test_scale_and_conjugate_match_jax():
    rng = np.random.default_rng(7)
    vel = rng.normal(0, 3, (5, 17, 17, 2)).astype(np.float32)
    homo = (np.eye(3) + rng.normal(0, 0.05, (5, 3, 3))).astype(np.float32)
    homo[:, 2, 2] = 1.0
    config = MeshFlowConfig()
    sx, sy = trackscale.scale_factors(1080, 1920, config)
    assert (sx, sy) == (1920 / 640, 1080 / 360)
    got_v = trackscale.scale_velocities(torch.from_numpy(vel), sx, sy).numpy()
    want_v = np.asarray(jts.scale_velocities(jnp.asarray(vel), sx, sy))
    np.testing.assert_allclose(got_v, want_v, rtol=1e-6)
    got_h = trackscale.conjugate_homographies(torch.from_numpy(homo), sx, sy).numpy()
    want_h = np.asarray(jts.conjugate_homographies(jnp.asarray(homo), sx, sy))
    np.testing.assert_allclose(got_h, want_h, rtol=1e-6)
    np.testing.assert_array_equal(got_h[:, 2, 2], 1.0)


def test_to_track_planes_gray_raises():
    """Gray track planes at d=1 and d=2: the gray of the box-downscaled
    frames, one plane (tests/test_torch_gray.py holds them against JAX);
    only a plane kind that does not exist raises."""
    frames = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 40, 64, 3),
                                                                  dtype=np.uint8))
    for d in (1, 2):
        config = MeshFlowConfig(track_planes="gray", track_downscale=d)
        got = trackscale.to_track_planes_dev(frames, config)
        want = bgr_to_gray(trackscale.box_downscale_dev(frames, d))[..., None]
        assert got.shape == (2, 40 // d, 64 // d, 1) and torch.equal(got, want)
    with pytest.raises(ValueError, match="track_planes"):
        MeshFlowConfig(track_planes="rgb")


def _clip(num_frames, h, w, pan, seed=0):
    """Seeded BGR clip: integer-shift crops of a blurred-noise canvas, a
    smooth pan to the right plus +-3 px jitter (tests/test_torch_slice.py)."""
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


def compare_track_slice(monkeypatch, fields, num_frames, h, w, variant=0):
    """The port's slice with `fields` against JAX ``_stabilize_frames``
    (MESHFLOW_RENDER=device) at the config's track geometry: the track
    planes and keypoints exact at (th, tw), JAX's motion there scaled
    back, solved and rendered against the port's (displacements within
    0.05 px, crop exact), then the output gates.  One render block
    (num_frames <= CHUNK).  Returns (th, tw)."""
    monkeypatch.setenv("MESHFLOW_RENDER", "device")
    frames = _clip(num_frames, h, w, pan=12)
    jc, tc = JaxConfig(**fields), MeshFlowConfig(**fields)
    th, tw = tc.track_shape(h, w)
    assert (th, tw) == jc.track_shape(h, w)

    js = JaxStabilizer(config=jc)
    jcropped, jratio, jdist, jstab = js._stabilize_frames(jnp.asarray(frames), variant, h, w)
    ts = MeshFlowStabilizer(config=tc, device="cpu")
    cropped, ratio, dist, stab = ts._stabilize_frames(torch.from_numpy(frames), variant)
    assert list(ts.last_timer.report()) == [
        "detect", "motion", "solver", "warp+crop", "metrics"
    ]

    # keypoints at track geometry, exact
    jtrack = jts.to_track_planes_dev(jnp.asarray(frames), jc)
    ttrack = trackscale.to_track_planes_dev(torch.from_numpy(frames), tc)
    np.testing.assert_array_equal(ttrack.numpy(), np.asarray(jtrack))
    jk, _ = jpipe.prepare_frames(jtrack, jc)
    tk, _ = tpipe.prepare_frames(ttrack, tc)
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    # JAX's motion at track geometry, scaled back, solved and rendered
    chunk = min(JaxStabilizer.CHUNK, num_frames)
    assert chunk == num_frames
    jm = jpipe.estimate_motion_chunked(
        jk, jtrack, jax.random.fold_in(js._key, 1), jc, th, tw,
        chunk_pairs=max(chunk - 1, 1),
    )
    sx, sy = w / tw, h / th
    jdisp = jts.scale_velocities(jm.displacements, sx, sy)
    jhomo = jts.conjugate_homographies(jm.homographies, sx, sy)
    jds = jjacobi(jdisp, jweights(jhomo, w, h, variant), jc.temporal_smoothing_radius,
                  jc.optimization_num_iterations)
    tm = ts.last_motion
    tds = jacobi_smooth(
        tm.displacements, adaptive_weights(tm.homographies, w, h, variant),
        tc.temporal_smoothing_radius, tc.optimization_num_iterations,
    )
    assert np.abs(tds.numpy() - np.asarray(jds)).max() <= 0.05
    grid = jnp.asarray(jgrid.vertex_grid(jc, h, w))
    _, jcrop = jrender.render_stabilized(jnp.asarray(frames), jdisp, jds, grid, jc, h, w)
    assert ts.last_crop.tolist() == [int(v) for v in np.asarray(jcrop)]

    assert cropped.shape == (num_frames, h, w, 3) and cropped.dtype == torch.uint8
    assert _psnr(cropped.numpy(), np.asarray(jcropped)) >= 40.0
    assert _rel(stab, jstab) <= 1e-3
    assert _rel(ratio, jratio) <= 1e-2
    assert _rel(dist, jdist) <= 1e-2
    return th, tw


def test_slice_track_downscale_2_matches_jax(monkeypatch):
    fields = dict(TINY, track_downscale=2)
    assert compare_track_slice(monkeypatch, fields, num_frames=12, h=180, w=320) == (90, 160)
