"""PyTorch port: motion estimation, propagation and the solver against the
JAX package on the same inputs.

Motion runs the whole stage-2 stack (FAST, LK, RANSAC with equal draws,
least squares, ellipse medians) on a synthetic integer-shift clip (the
pattern of tests/test_motion.py).  Keypoints are exact; LK endpoints
carry float32 round-off through up to 30 iterations (see
test_torch_lk.py), which moves the per-vertex medians and the fitted
homographies slightly: displacements within 0.02 px, homographies within
1e-3 relative to their largest entry.  The solver is fed JAX's own motion
state through ``interop``, so it sees identical inputs: float32
agreement to 1e-5.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu.config import MeshFlowConfig as JaxConfig
from meshflow_tpu.motion import pipeline as jpipe
from meshflow_tpu.motion import propagate as jprop
from meshflow_tpu.motion.features import MatchResult
from meshflow_tpu.solver import jacobi as jjacobi
from meshflow_tpu.solver import weights as jweights
from meshflow_tpu.utils import grid as jgrid

from meshflow_tpu_torch import interop
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.motion import pipeline as tpipe
from meshflow_tpu_torch.motion import propagate as tprop
from meshflow_tpu_torch.solver import jacobi, weights
from meshflow_tpu_torch.utils import grid, prng


def _synthetic_clip(rng, num_frames=8, h=180, w=320, max_shift=12):
    """Integer-shift crops of one textured canvas (tests/test_motion.py)."""
    canvas = rng.integers(
        0, 256, size=((h + 4 * max_shift) // 6, (w + 4 * max_shift) // 6), dtype=np.uint8
    )
    canvas = cv2.resize(canvas, (w + 4 * max_shift, h + 4 * max_shift), interpolation=cv2.INTER_NEAREST)
    canvas = cv2.GaussianBlur(canvas, (5, 5), 1.0)
    canvas = cv2.cvtColor(canvas, cv2.COLOR_GRAY2BGR)
    shifts = [np.array([0, 0])]
    for _ in range(num_frames - 1):
        shifts.append(np.clip(shifts[-1] + rng.integers(-3, 4, size=2), -max_shift, max_shift))
    frames = [
        canvas[2 * max_shift + s[1] : 2 * max_shift + s[1] + h,
               2 * max_shift + s[0] : 2 * max_shift + s[0] + w].copy()
        for s in shifts
    ]
    return np.stack(frames), np.array(shifts)


@pytest.fixture(scope="module")
def motion_pair():
    """JAX and port motion of one synthetic clip (JAX compiles once)."""
    rng = np.random.default_rng(1234)
    frames, shifts = _synthetic_clip(rng)
    jc = JaxConfig(max_features_per_subframe=128)
    tc = MeshFlowConfig(max_features_per_subframe=128)
    key = jax.random.PRNGKey(0)
    jk, _ = jpipe.prepare_frames(jnp.asarray(frames), jc)
    jm = jpipe.estimate_motion_scanned(jk, jnp.asarray(frames), key, jc, 180, 320)
    # the port starts from JAX's keypoints, carried over as numpy arrays
    tk = interop.keypoints_from_numpy(*(np.asarray(a) for a in jk))
    tm = tpipe.estimate_motion_chunked(
        tk, torch.from_numpy(frames), interop.key_from_jax(np.asarray(key)), tc,
        180, 320, chunk_pairs=len(frames) - 1,
    )
    return frames, shifts, jm, tm


def test_motion_matches_jax(motion_pair):
    frames, shifts, jm, tm = motion_pair
    disp = tm.displacements.numpy()
    assert bool(tm.pair_ok.all()) and bool(np.asarray(jm.pair_ok).all())
    np.testing.assert_allclose(disp, np.asarray(jm.displacements), rtol=0, atol=0.02)
    homos, jh = tm.homographies.numpy(), np.asarray(jm.homographies)
    assert (np.abs(homos - jh).max(axis=(1, 2)) / np.abs(jh).max(axis=(1, 2))).max() < 1e-3
    np.testing.assert_array_equal(homos[-1], np.eye(3))
    # and both follow the known shifts
    expected = -(shifts - shifts[0])
    np.testing.assert_allclose(disp[:, 8, 8], expected, atol=0.25)


def test_keypoints_and_tile_planes_match_jax(motion_pair):
    frames = motion_pair[0]
    jc = JaxConfig(max_features_per_subframe=128)
    tc = MeshFlowConfig(max_features_per_subframe=128)
    jk, jg = jpipe.prepare_frames(jnp.asarray(frames), jc)
    tk, tg = tpipe.prepare_frames(torch.from_numpy(frames), tc)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    for a, b in zip(tk, jk):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jplanes, jdims = jpipe.pack_tile_planes_u8(jnp.asarray(frames[:3]), jc, 2)
    tplanes, tdims = tpipe.pack_tile_planes_u8(torch.from_numpy(frames[:3]), tc, 2)
    assert tdims == jdims
    for a, b in zip(tplanes, jplanes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_vertex_velocities_match_jax(rng):
    config = JaxConfig()
    h, w, n = 360, 640, 300
    early = rng.uniform([5, 5], [w - 5, h - 5], size=(n, 2)).astype(np.float32)
    hmat = np.array([[1.01, 0.02, 4.0], [-0.01, 0.99, -3.0], [1e-5, 2e-5, 1.0]], np.float32)
    late = early @ hmat[:2, :2].T + hmat[:2, 2] + rng.normal(0, 0.7, (n, 2)).astype(np.float32)
    inlier = rng.random(n) < 0.8
    vg = jgrid.vertex_grid(config, h, w)
    ref = jprop.vertex_velocities(
        MatchResult(jnp.asarray(early), jnp.asarray(late), jnp.asarray(inlier),
                    jnp.asarray(hmat), jnp.asarray(True)),
        jnp.asarray(vg), config, h, w,
    )
    tc = MeshFlowConfig()
    ours = tprop.vertex_velocities(
        torch.from_numpy(early)[None], torch.from_numpy(late)[None],
        torch.from_numpy(inlier)[None], torch.from_numpy(hmat)[None],
        grid.vertex_grid(tc, h, w), tc, h, w,
    )[0]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    member = tprop.ellipse_membership(torch.from_numpy(early), torch.from_numpy(inlier), tc, h, w)
    np.testing.assert_array_equal(
        member.numpy(),
        np.asarray(jprop.ellipse_membership(jnp.asarray(early), jnp.asarray(inlier), config, h, w)),
    )


@pytest.mark.parametrize("variant", [0, 1, 2, 3])
def test_solver_matches_jax_on_jax_motion(motion_pair, variant):
    _, _, jm, _ = motion_pair
    h, w = 180, 320
    motion = interop.motion_from_numpy(
        np.asarray(jm.displacements), np.asarray(jm.homographies), np.asarray(jm.pair_ok)
    )
    lam = weights.adaptive_weights(motion.homographies, w, h, variant)
    jlam = jweights.adaptive_weights(jm.homographies, w, h, variant)
    np.testing.assert_allclose(lam.numpy(), np.asarray(jlam), rtol=1e-5, atol=1e-6)
    ours = jacobi.jacobi_smooth(motion.displacements, lam, 10, 100)
    ref = jjacobi.jacobi_smooth(jm.displacements, jlam, 10, 100)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_prng_keys_per_pair_match_jax():
    key = jax.random.fold_in(jax.random.PRNGKey(0), 1)
    ours = prng.fold_in(interop.key_from_jax(np.asarray(key)), torch.arange(5) + 63)
    for t in range(5):
        np.testing.assert_array_equal(
            ours[t].numpy(), np.asarray(jax.random.fold_in(key, t + 63))
        )
