"""PyTorch port: the eig9 kernel's arithmetic (``csrc/eig9.cu``), emulated
operation for operation by ``eig9_cuda.null_vector_jacobi``, against
``torch.linalg.eigh``, the plain version, on the CPU.

The inputs are the DLT's normal matrices (``homography.dlt_normal``) of
point sets the JAX package makes: early points mapped through a
homography by its ``apply_homography``, with noise and outliers, weighted
by its RANSAC's inlier masks; then rank-deficient, repeated-eigenvalue
and zero matrices.  Gate, where eigh's eigenvalue gap exceeds
1e-9 ||N||_F: the float32 homography matches eigh's to 1e-5 relative;
everywhere the Rayleigh quotient v'Nv <= lambda_0 + 1e-12 ||N||_F, the
vector is finite and of unit norm.  Degenerate point sets (too few,
coincident, collinear) give the same RANSAC masks and ok with either
null vector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu.kernels import homography as jhom

from meshflow_tpu_torch.kernels import eig9_cuda, homography
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)


def _jax_point_sets(seed, sets=48, n=96):
    """(early, late, weights) float32 numpy: JAX-mapped points with noise
    and 25% outliers, weighted by the JAX RANSAC's inlier masks."""
    rng = np.random.default_rng(seed)
    early = rng.uniform(0, 320, (sets, n, 2)).astype(np.float32)
    h = np.tile(np.eye(3, dtype=np.float32), (sets, 1, 1))
    h[:, :2, :2] += rng.normal(0, 0.03, (sets, 2, 2))
    h[:, :2, 2] = rng.normal(0, 5, (sets, 2))
    h[:, 2, :2] = rng.normal(0, 2e-5, (sets, 2))
    late = np.asarray(jhom.apply_homography(jnp.asarray(h), jnp.asarray(early)))
    late = late + rng.normal(0, 0.5, late.shape).astype(np.float32)
    outlier = rng.random((sets, n)) < 0.25
    late = np.where(outlier[..., None], rng.uniform(0, 320, late.shape), late).astype(np.float32)
    valid = rng.random((sets, n)) < 0.9
    keys = jax.random.split(jax.random.PRNGKey(seed), sets)
    ransac = jax.jit(jax.vmap(lambda e, l, v, k: jhom.ransac_homography(e, l, v, k,
                                                                         iterations=64)))
    _, mask, _ = ransac(jnp.asarray(early), jnp.asarray(late), jnp.asarray(valid), keys)
    return early, late, np.asarray(mask).astype(np.float32)


@pytest.fixture(scope="module")
def dlt_normals():
    parts = [_jax_point_sets(seed) for seed in (0, 1)]
    early, late, weights = (torch.from_numpy(np.concatenate(p)) for p in zip(*parts))
    return early, late, weights, homography.dlt_normal(early, late, weights)


def _gate(normal, vec):
    w, _ = torch.linalg.eigh(normal)
    fro = torch.linalg.matrix_norm(normal)
    rq = torch.einsum("bi,bij,bj->b", vec, normal, vec)
    assert torch.isfinite(vec).all()
    np.testing.assert_allclose(vec.norm(dim=-1).numpy(), 1.0, atol=1e-12)
    assert (rq <= w[:, 0] + 1e-12 * fro).all(), (rq - w[:, 0] - 1e-12 * fro).max()
    return w, fro


def test_emulation_matches_eigh_on_dlt_normals(dlt_normals):
    early, late, weights, (normal, early_t, late_t) = dlt_normals
    vec, sweeps = eig9_cuda.null_vector_jacobi(normal, return_sweeps=True)
    w, fro = _gate(normal, vec)
    assert (sweeps < eig9_cuda.MAX_SWEEPS).all() and (sweeps >= 1).all()
    gapped = (w[:, 1] - w[:, 0]) > 1e-9 * fro
    assert gapped.float().mean() > 0.9
    h_emu = homography.dlt_from_null_vector(vec, early_t, late_t)
    h_eigh = homography.dlt_from_null_vector(eig9_cuda.null_vector_plain(normal), early_t,
                                             late_t)
    scale = h_eigh.abs().flatten(-2).amax(-1)
    rel = ((h_emu - h_eigh).abs().flatten(-2).amax(-1) / scale)[gapped]
    assert rel.max() <= 1e-5, rel.max()
    # the CPU route of the wrapper is eigh itself
    assert torch.equal(homography.dlt_homography(early, late, weights), h_eigh)


def _degenerate_normals():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(6, 8, 9))  # rank 8: a one-dimensional null space
    rank8 = x.transpose(0, 2, 1) @ x
    y = rng.normal(size=(4, 6, 9))  # rank 6: a three-dimensional null space
    rank6 = y.transpose(0, 2, 1) @ y
    q, _ = np.linalg.qr(rng.normal(size=(4, 9, 9)))
    repeated = q @ np.diag([0.5, 0.5, 1, 1, 1, 2, 2, 3, 3])[None] @ q.transpose(0, 2, 1)
    return torch.from_numpy(np.concatenate([
        rank8, rank6, repeated, np.eye(9)[None].repeat(2, 0), np.zeros((3, 9, 9)),
        np.diag(np.arange(9.0, 0.0, -1.0))[None],
    ]))


def test_emulation_on_degenerate_matrices():
    normal = _degenerate_normals()
    vec, sweeps = eig9_cuda.null_vector_jacobi(normal, return_sweeps=True)
    _gate(normal, vec)
    assert (sweeps < eig9_cuda.MAX_SWEEPS).all()
    # a zero matrix and the identity need no rotation: the first unit vector
    assert (sweeps[-6:-1] == 0).all()
    np.testing.assert_array_equal(vec[-6:-1].numpy(), np.eye(9)[[0] * 5])
    # a diagonal matrix rotates nothing: the last axis holds the least entry
    np.testing.assert_array_equal(vec[-1].numpy(), np.eye(9)[8])


def test_degenerate_point_sets_give_the_same_masks(monkeypatch):
    """Too few points, coincident points, collinear points, no valid point:
    the RANSAC masks and ok of the emulated kernel equal eigh's."""
    rng = np.random.default_rng(3)
    n = 64
    early = rng.uniform(0, 100, (6, n, 2)).astype(np.float32)
    late = early + 2.0
    valid = np.ones((6, n), bool)
    valid[0, 3:] = False  # three points
    early[1] = early[1, :1]  # one point, repeated
    late[1] = late[1, :1]
    early[2, :, 1] = 0.5 * early[2, :, 0] + 3.0  # collinear
    late[2] = early[2] + 2.0
    valid[3] = False  # nothing valid
    late[4, ::3] += 40.0  # a third are outliers
    args = [torch.from_numpy(a) for a in (early, late, valid)]
    key = torch.stack([torch.zeros(6, dtype=torch.int64), torch.arange(6)], -1)
    want = homography.ransac_homography(*args, key, iterations=64, polish_rounds=2)
    monkeypatch.setattr(eig9_cuda, "null_vector", eig9_cuda.null_vector_jacobi)
    got = homography.ransac_homography(*args, key, iterations=64, polish_rounds=2)
    assert torch.isfinite(got[0]).all()
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert not got[2][[0, 3]].any() and got[2][[4, 5]].all()


def test_null_vector_routes_by_device():
    normal = _degenerate_normals()[:4]
    assert torch.equal(eig9_cuda.null_vector(normal), eig9_cuda.null_vector_plain(normal))
    with pytest.raises(ValueError):
        eig9_cuda.null_vector(normal.to("meta"))
    with pytest.raises(ValueError):
        eig9_cuda.null_vector(normal.float().to("meta"))
