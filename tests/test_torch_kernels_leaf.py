"""PyTorch port: leaf kernels against their JAX twins on the same inputs.

Integer kernels (colour, FAST, pyramid) must be exact.  Float kernels
compare at float32 precision: 1e-6 where the arithmetic is the same
elementwise sequence, 1e-5 relative (to the matrix's largest entry) for
the homography solves, whose reductions and linear solves run in another
order, and whose DLT null vector the port takes from a float64
eigendecomposition where JAX takes a float32 SVD.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu.config import MeshFlowConfig as JaxConfig
from meshflow_tpu.kernels import color as jcolor
from meshflow_tpu.kernels import eig3 as jeig3
from meshflow_tpu.kernels import fast as jfast
from meshflow_tpu.kernels import homography as jhom
from meshflow_tpu.kernels import median as jmedian
from meshflow_tpu.kernels import pyramid as jpyr

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels import color, eig3, fast, homography, median, pyramid
from meshflow_tpu_torch.utils import prng


def _t(a):
    return torch.from_numpy(np.array(a))


def test_bgr_to_gray_exact(rng):
    bgr = rng.integers(0, 256, (4, 33, 65, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        color.bgr_to_gray(_t(bgr)).numpy(), np.asarray(jcolor.bgr_to_gray(jnp.asarray(bgr)))
    )


@pytest.mark.parametrize("shape,levels", [((3, 90, 160), 2), ((2, 45, 81), 3), ((23, 40), 1)])
def test_pyramid_exact(rng, shape, levels):
    img = rng.integers(0, 256, shape).astype(np.float32)
    ours = pyramid.build_pyramid(_t(img), levels)
    ref = jpyr.build_pyramid(jnp.asarray(img), levels)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_medians_match(rng):
    values = rng.normal(size=(6, 5, 40)).astype(np.float32)
    mask = rng.random((6, 5, 40)) < 0.3
    mask[0, 0] = False  # empty set -> 0
    np.testing.assert_array_equal(
        median.masked_median(_t(values), _t(mask)).numpy(),
        np.asarray(jmedian.masked_median(jnp.asarray(values), jnp.asarray(mask))),
    )
    field = rng.normal(size=(3, 17, 17)).astype(np.float32)
    np.testing.assert_array_equal(
        median.median3x3(_t(field)).numpy(),
        np.asarray(jmedian.median3x3(jnp.asarray(field))),
    )


def test_eig3_matches(rng):
    h = rng.normal(size=(64, 3, 3)).astype(np.float32)
    h[:8, :2, :2] = [[1.0, -0.5], [0.5, 1.0]]  # complex pairs
    np.testing.assert_allclose(
        eig3.affine_eigenvalue_magnitudes(_t(h)).numpy(),
        np.asarray(jeig3.affine_eigenvalue_magnitudes(jnp.asarray(h))),
        rtol=1e-6, atol=1e-6,
    )
    np.testing.assert_allclose(
        eig3.affine_eigen_ratio(_t(h)).numpy(),
        np.asarray(jeig3.affine_eigen_ratio(jnp.asarray(h))),
        rtol=1e-6, atol=1e-6,
    )


def _tiled(rng, f, h, w, period):
    """A random patch repeated over the frame: every repetition of a
    corner scores the same, so top-K must order equal scores."""
    patch = rng.integers(0, 256, (f, period, period), dtype=np.uint8)
    return np.tile(patch, (1, h // period + 1, w // period + 1))[:, :h, :w]


@pytest.mark.parametrize(
    "h,w,rows,cols,k,pattern",
    [
        (90, 160, 2, 2, 64, "noise"),
        (96, 128, 2, 2, 64, "tied"),  # repeated blocks: many equal scores
        (61, 75, 3, 2, 32, "noise"),  # non-divisible subframes
        (48, 64, 2, 2, 512, "tied"),  # capacity above the subframe area
    ],
)
def test_fast_keypoints_exact(rng, h, w, rows, cols, k, pattern):
    kw = dict(
        mesh_outlier_subframe_row_count=rows,
        mesh_outlier_subframe_col_count=cols,
        max_features_per_subframe=k,
    )
    if pattern == "noise":
        gray = rng.integers(0, 256, (2, h, w), dtype=np.uint8)
    else:
        gray = _tiled(rng, 2, h, w, 7)
    ours = fast.detect_keypoints(_t(gray), MeshFlowConfig(**kw), h, w)
    ref = jfast.detect_keypoints(jnp.asarray(gray), JaxConfig(**kw), h, w)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    scores = ours.scores.numpy()[ours.valid.numpy()]
    if pattern == "tied":
        assert len(scores) > len(np.unique(scores))  # ties were exercised


def _point_sets(rng, n, batch, noise=0.5, outliers=0.0):
    e = rng.uniform(0, 160, (batch, n, 2)).astype(np.float32)
    hs = np.tile(np.eye(3, dtype=np.float32), (batch, 1, 1))
    hs[:, :2, :2] += rng.normal(0, 0.02, (batch, 2, 2))
    hs[:, :2, 2] = rng.uniform(-8, 8, (batch, 2))
    hs[:, 2, :2] = rng.normal(0, 2e-4, (batch, 2))
    l = np.asarray(jhom.apply_homography(jnp.asarray(hs), jnp.asarray(e)))
    l = l + rng.normal(0, noise, l.shape).astype(np.float32)
    bad = rng.random((batch, n)) < outliers
    l[bad] += rng.uniform(-40, 40, (int(bad.sum()), 2)).astype(np.float32)
    return e, l.astype(np.float32)


def _rel(a, b):
    return np.abs(a - b).max(axis=(-2, -1)) / np.abs(b).max(axis=(-2, -1))


def _dlt_float64(e, l, w):
    """The normalized weighted DLT in float64 (numpy SVD): the exact
    answer both float32 implementations approximate."""

    def normalize(p):
        ws = max(w.sum(), 1e-6)
        c = (p * w[:, None]).sum(0) / ws
        centered = p - c
        s = np.sqrt(2.0) / max(np.sqrt((w * (centered**2).sum(-1)).sum() / ws), 1e-6)
        return centered * s, np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])

    en, te = normalize(e.astype(np.float64))
    ln, tl = normalize(l.astype(np.float64))
    x, y = en.T
    xp, yp = ln.T
    z, o = np.zeros_like(x), np.ones_like(x)
    a = np.concatenate([
        np.stack([x, y, o, z, z, z, -x * xp, -y * xp, -xp], -1),
        np.stack([z, z, z, x, y, o, -x * yp, -y * yp, -yp], -1),
    ])
    _, _, vt = np.linalg.svd(a * np.sqrt(np.concatenate([w, w]))[:, None])
    h = np.linalg.solve(tl, vt[-1].reshape(3, 3) @ te)
    return h / h[2, 2]


def test_homography_solves_match(rng):
    e, l = _point_sets(rng, 96, 4)
    w = (rng.random((4, 96)) < 0.8).astype(np.float32)
    ref = {}
    for name in ("dlt_homography", "estimate_homography"):
        ours = getattr(homography, name)(_t(e), _t(l), _t(w)).numpy()
        ref[name] = np.stack([
            np.asarray(getattr(jhom, name)(jnp.asarray(e[i]), jnp.asarray(l[i]), jnp.asarray(w[i])))
            for i in range(4)
        ])
        if name == "estimate_homography":
            assert _rel(ours, ref[name]).max() < 1e-5, name
            continue
        # The DLT alone: the port's float64 null vector is exact to 1e-6;
        # JAX's float32 SVD is off the exact answer by up to ~2e-5 on these
        # sets, so the port is held to the exact answer and to JAX within
        # JAX's own float32 error.
        exact = np.stack([_dlt_float64(e[i], l[i], w[i].astype(np.float64)) for i in range(4)])
        assert _rel(ours, exact).max() < 1e-6
        assert _rel(ref[name], exact).max() < 5e-5
        assert _rel(ours, ref[name]).max() < 5e-5
    h0 = np.asarray(jhom.dlt_homography(jnp.asarray(e[0]), jnp.asarray(l[0]), jnp.asarray(w[0])))
    ours = homography.refine_homography(_t(h0), _t(e[0]), _t(l[0]), _t(w[0]), 10).numpy()
    ref = np.asarray(jhom.refine_homography(jnp.asarray(h0), jnp.asarray(e[0]), jnp.asarray(l[0]), jnp.asarray(w[0]), 10))
    assert _rel(ours, ref) < 1e-5
    q1 = rng.uniform(0, 60, (16, 4, 2)).astype(np.float32)
    q2 = (q1 + rng.normal(0, 3, q1.shape)).astype(np.float32)
    ours = homography.quad_to_quad_homography(_t(q1), _t(q2)).numpy()
    ref = np.asarray(jhom.quad_to_quad_homography(jnp.asarray(q1), jnp.asarray(q2)))
    assert _rel(ours, ref).max() < 1e-5
    pts = rng.uniform(0, 100, (5, 2)).astype(np.float32)
    np.testing.assert_allclose(
        homography.apply_homography(_t(ref[0]), _t(pts)).numpy(),
        np.asarray(jhom.apply_homography(jnp.asarray(ref[0]), jnp.asarray(pts))),
        rtol=1e-6, atol=1e-5,
    )


@pytest.mark.parametrize("polish", [0, 2])
def test_ransac_masks_equal_with_equal_draws(rng, polish):
    batch, n = 6, 128
    e, l = _point_sets(rng, n, batch, noise=0.3, outliers=0.25)
    valid = rng.random((batch, n)) < 0.9
    valid[-1, 3:] = False  # too few points: ok must be False
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 5), batch)
    h, mask, ok = homography.ransac_homography(
        _t(e), _t(l), _t(valid), prng.key_data(np.asarray(keys)),
        iterations=128, polish_rounds=polish,
    )
    for i in range(batch):
        jh, jmask, jok = jhom.ransac_homography(
            jnp.asarray(e[i]), jnp.asarray(l[i]), jnp.asarray(valid[i]), keys[i],
            iterations=128, polish_rounds=polish,
        )
        assert bool(ok[i]) == bool(jok)
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(jmask), err_msg=f"set {i}")
        assert _rel(h[i].numpy(), np.asarray(jh)) < 1e-5
    assert not bool(ok[-1]) and bool(ok[:-1].all())
