"""Batched homography estimation: the port of
``meshflow_tpu/kernels/homography.py``.

* ``apply_homography`` — cv2.perspectiveTransform.
* ``estimate_homography`` — cv2.findHomography(method=0): Hartley-
  normalized DLT, then Gauss-Newton on the geometric transfer error.
* ``quad_to_quad_homography`` — the exact 4-point map in closed form.
* ``ransac_homography`` — fixed-iteration seeded RANSAC with the LO polish,
  batched over every (pair, subframe) at once; its draws come from the
  JAX-compatible key tree in ``utils/prng`` so they equal the JAX
  package's draw for draw.

Every function takes leading batch dimensions; point sets are fixed
capacity with weight-0 (or invalid) rows instead of ragged arrays.

The DLT's null vector comes from the 9x9 normal matrix, formed and
eigendecomposed in float64.  The JAX package takes the SVD of the
weighted design matrix in float32 to avoid squaring its condition
number; float64 leaves that squared condition number far inside its
precision, and a batched 9x9 symmetric eigensolve runs as one call on
the card where a batched SVD of (2N, 9) matrices does not.
"""

from __future__ import annotations

import torch

from meshflow_tpu_torch.utils import prng


def apply_homography(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """h: (..., 3, 3); pts: (..., N, 2) -> (..., N, 2)."""
    x, y = pts[..., 0], pts[..., 1]
    w = h[..., 2:3, 0] * x + h[..., 2:3, 1] * y + h[..., 2:3, 2]
    xn = h[..., 0:1, 0] * x + h[..., 0:1, 1] * y + h[..., 0:1, 2]
    yn = h[..., 1:2, 0] * x + h[..., 1:2, 1] * y + h[..., 1:2, 2]
    w = torch.where(torch.abs(w) < 1e-10, torch.full_like(w, 1e-10), w)
    return torch.stack([xn / w, yn / w], dim=-1)


def _safe(v: torch.Tensor, floor: float) -> torch.Tensor:
    return torch.where(torch.abs(v) < floor, torch.full_like(v, floor), v)


def _normalize_points(pts: torch.Tensor, weights: torch.Tensor):
    """Hartley normalization of weighted point sets (..., N, 2).

    Returns (normalized points, (scale, cx, cy)) with
    normalized = scale * (pts - c).
    """
    wsum = torch.clamp(weights.sum(-1), min=1e-6)
    centroid = (pts * weights[..., None]).sum(-2) / wsum[..., None]
    centered = pts - centroid[..., None, :]
    rms = torch.sqrt((weights * (centered**2).sum(-1)).sum(-1) / wsum)
    scale = torch.sqrt(torch.tensor(2.0, dtype=pts.dtype)) / torch.clamp(
        rms, min=1e-6
    )
    return centered * scale[..., None, None], (scale, centroid)


def _similarity(scale, centroid) -> torch.Tensor:
    """T = [[s, 0, -s cx], [0, s, -s cy], [0, 0, 1]]."""
    t = torch.zeros(scale.shape + (3, 3), dtype=scale.dtype, device=scale.device)
    t[..., 0, 0] = scale
    t[..., 1, 1] = scale
    t[..., 0, 2] = -scale * centroid[..., 0]
    t[..., 1, 2] = -scale * centroid[..., 1]
    t[..., 2, 2] = 1.0
    return t


def _similarity_inverse(scale, centroid) -> torch.Tensor:
    """Closed-form inverse of _similarity: [[1/s, 0, cx], [0, 1/s, cy]]."""
    t = torch.zeros(scale.shape + (3, 3), dtype=scale.dtype, device=scale.device)
    t[..., 0, 0] = 1.0 / scale
    t[..., 1, 1] = 1.0 / scale
    t[..., 0, 2] = (scale * centroid[..., 0]) / scale
    t[..., 1, 2] = (scale * centroid[..., 1]) / scale
    t[..., 2, 2] = 1.0
    return t


def dlt_homography(
    early: torch.Tensor, late: torch.Tensor, weights: torch.Tensor
) -> torch.Tensor:
    """Weighted normalized DLT: (..., N, 2) x2, (..., N) -> (..., 3, 3) f32
    normalized to H[2,2] = 1."""
    e64, l64, w64 = early.double(), late.double(), weights.double()
    en, (se, ce) = _normalize_points(e64, w64)
    ln, (sl, cl) = _normalize_points(l64, w64)
    x, y = en[..., 0], en[..., 1]
    xp, yp = ln[..., 0], ln[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    row1 = torch.stack(
        [x, y, ones, zeros, zeros, zeros, -x * xp, -y * xp, -xp], dim=-1
    )
    row2 = torch.stack(
        [zeros, zeros, zeros, x, y, ones, -x * yp, -y * yp, -yp], dim=-1
    )
    normal = torch.einsum("...n,...ni,...nj->...ij", w64, row1, row1)
    normal = normal + torch.einsum("...n,...ni,...nj->...ij", w64, row2, row2)
    _, vecs = torch.linalg.eigh(normal)
    hn = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    h = _similarity_inverse(sl, cl) @ hn @ _similarity(se, ce)
    h = h / _safe(h[..., 2:3, 2:3], 1e-10)
    return h.float()


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) as explicit float32 products and sums, so
    the result is the same on every device."""
    return (
        a[..., :, 0:1] * b[..., 0:1, :]
        + a[..., :, 1:2] * b[..., 1:2, :]
        + a[..., :, 2:3] * b[..., 2:3, :]
    )


def refine_homography(
    h: torch.Tensor,
    early: torch.Tensor,
    late: torch.Tensor,
    weights: torch.Tensor,
    iterations: int = 10,
) -> torch.Tensor:
    """Gauss-Newton on the geometric transfer error in Hartley-normalized
    coordinates, H[2,2] pinned to 1, keeping the best parameters seen."""
    en, (se, ce) = _normalize_points(early, weights)
    ln, (sl, cl) = _normalize_points(late, weights)
    hn = _similarity(sl, cl) @ h @ _similarity_inverse(se, ce)
    hn = hn / _safe(hn[..., 2:3, 2:3], 1e-10)
    batch = h.shape[:-2]
    params0 = hn.reshape(batch + (9,))[..., :8]
    x, y = en[..., 0], en[..., 1]
    eye8 = torch.eye(8, dtype=h.dtype, device=h.device)

    def cost_and_system(p):
        d = p[..., 6:7] * x + p[..., 7:8] * y + 1.0
        d = _safe(d, 1e-10)
        xi = (p[..., 0:1] * x + p[..., 1:2] * y + p[..., 2:3]) / d
        yi = (p[..., 3:4] * x + p[..., 4:5] * y + p[..., 5:6]) / d
        rx = xi - ln[..., 0]
        ry = yi - ln[..., 1]
        cost = (weights * (rx**2 + ry**2)).sum(-1)
        zeros = torch.zeros_like(x)
        inv_d = 1.0 / d
        jx = torch.stack(
            [x * inv_d, y * inv_d, inv_d, zeros, zeros, zeros,
             -x * xi * inv_d, -y * xi * inv_d], dim=-1)
        jy = torch.stack(
            [zeros, zeros, zeros, x * inv_d, y * inv_d, inv_d,
             -x * yi * inv_d, -y * yi * inv_d], dim=-1)
        jxw = jx * weights[..., None]
        jyw = jy * weights[..., None]
        jtj = jxw.transpose(-1, -2) @ jx + jyw.transpose(-1, -2) @ jy
        jtr = (jxw.transpose(-1, -2) @ rx[..., None])[..., 0] + (
            jyw.transpose(-1, -2) @ ry[..., None]
        )[..., 0]
        return cost, jtj, jtr

    params = params0
    best_params = params0
    best_cost = torch.full(batch, float("inf"), dtype=h.dtype, device=h.device)
    for _ in range(iterations):
        cost, jtj, jtr = cost_and_system(params)
        better = cost < best_cost
        best_params = torch.where(better[..., None], params, best_params)
        best_cost = torch.where(better, cost, best_cost)
        trace = jtj.diagonal(dim1=-2, dim2=-1).sum(-1)
        damped = jtj + 1e-6 * eye8 * trace[..., None, None]
        step = torch.linalg.solve_ex(damped, jtr[..., None])[0][..., 0]
        finite = torch.isfinite(step).all(-1, keepdim=True)
        step = torch.where(finite, step, torch.zeros_like(step))
        params = params - step
    final_cost, _, _ = cost_and_system(params)
    best_params = torch.where(
        (final_cost < best_cost)[..., None], params, best_params
    )
    ones = torch.ones(batch + (1,), dtype=h.dtype, device=h.device)
    hn_refined = torch.cat([best_params, ones], -1).reshape(batch + (3, 3))
    out = _similarity_inverse(sl, cl) @ hn_refined @ _similarity(se, ce)
    return out / _safe(out[..., 2:3, 2:3], 1e-10)


def estimate_homography(
    early: torch.Tensor,
    late: torch.Tensor,
    weights: torch.Tensor,
    refine_iterations: int = 10,
) -> torch.Tensor:
    """DLT + Gauss-Newton: the cv2.findHomography(method=0) analog."""
    h = dlt_homography(early, late, weights)
    return refine_homography(h, early, late, weights, refine_iterations)


def unit_square_to_quad(quad: torch.Tensor) -> torch.Tensor:
    """Heckbert's projective map from the unit square onto a quad.

    quad: (..., 4, 2) corners ordered [(0,0), (1,0), (0,1), (1,1)] ->
    (..., 3, 3); exact for parallelograms."""
    a, b, c, d = quad[..., 0, :], quad[..., 1, :], quad[..., 2, :], quad[..., 3, :]
    sigma = a - b - c + d
    d1 = b - d
    d2 = c - d
    den = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    den = _safe(den, 1e-12)
    g = (sigma[..., 0] * d2[..., 1] - sigma[..., 1] * d2[..., 0]) / den
    h = (d1[..., 0] * sigma[..., 1] - d1[..., 1] * sigma[..., 0]) / den
    row0 = torch.stack(
        [b[..., 0] - a[..., 0] + g * b[..., 0],
         c[..., 0] - a[..., 0] + h * c[..., 0],
         a[..., 0]], dim=-1)
    row1 = torch.stack(
        [b[..., 1] - a[..., 1] + g * b[..., 1],
         c[..., 1] - a[..., 1] + h * c[..., 1],
         a[..., 1]], dim=-1)
    row2 = torch.stack([g, h, torch.ones_like(g)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def adjugate3(m: torch.Tensor) -> torch.Tensor:
    """Adjugate of (..., 3, 3): the inverse up to scale."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )


def quad_to_quad_homography(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact homography taking src quad corners onto dst quad corners
    ((..., 4, 2) ordered [tl, tr, bl, br]); homogeneous, not normalized."""
    return _matmul3(unit_square_to_quad(dst), adjugate3(unit_square_to_quad(src)))


def sample_distinct4(
    key: torch.Tensor, iterations: int, num_valid: torch.Tensor
) -> torch.Tensor:
    """(..., iterations, 4) distinct draws, uniform over [0, num_valid).

    Sequential inverse-CDF sampling without replacement, draw for draw the
    JAX package's ``_sample_distinct4``; key (..., 2), num_valid (...)."""
    m = num_valid.to(torch.int64)
    keys = prng.split(key, 4)
    d0, d1, d2, d3 = (
        prng.randint(keys[..., i, :], iterations, 0, torch.clamp(m - i, min=1))
        for i in range(4)
    )
    d1 = d1 + (d1 >= d0)
    lo, hi = torch.minimum(d0, d1), torch.maximum(d0, d1)
    d2 = d2 + (d2 >= lo)
    d2 = d2 + (d2 >= hi)
    a = torch.minimum(lo, d2)
    c = torch.maximum(hi, d2)
    b = d0 + d1 + d2 - a - c
    d3 = d3 + (d3 >= a)
    d3 = d3 + (d3 >= b)
    d3 = d3 + (d3 >= c)
    return torch.stack([d0, d1, d2, d3], dim=-1)


def _all_finite(h: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(h).flatten(-2).all(-1)


# Point sets scored together in one RANSAC consensus block: bounds the
# (block, iterations, N) error tensors to ~70 MB at N=512.
_RANSAC_BLOCK = 128


def _consensus(early, late, valid, h_candidates, thr2):
    """Best-count inlier mask per point set: (B, N) bool and (B,) counts."""
    iters = h_candidates.shape[-3]
    proj = apply_homography(h_candidates, early[:, None].expand(-1, iters, -1, -1))
    err2 = ((proj - late[:, None]) ** 2).sum(-1)  # (B, iters, N)
    finite = _all_finite(h_candidates)
    inlier = (err2 < thr2) & valid[:, None] & finite[..., None]
    counts = inlier.sum(-1)
    best = torch.argmax(counts, dim=-1)  # first maximum, like jnp.argmax
    idx = best[:, None, None].expand(-1, 1, inlier.shape[-1])
    return torch.gather(inlier, 1, idx)[:, 0], torch.gather(counts, 1, best[:, None])[:, 0]


def ransac_homography(
    early: torch.Tensor,
    late: torch.Tensor,
    valid: torch.Tensor,
    key: torch.Tensor,
    threshold: float = 3.0,
    iterations: int = 256,
    refine_iterations: int = 10,
    polish_rounds: int = 0,
):
    """Fixed-iteration RANSAC homography per point set.

    early, late: (..., N, 2) float32; valid: (..., N) bool; key: (..., 2).
    Returns (h (..., 3, 3), inlier_mask (..., N), ok (...)), where ok is
    False when fewer than 4 valid points exist or no model reached 4
    inliers.
    """
    batch = valid.shape[:-1]
    n = valid.shape[-1]
    early = early.reshape(-1, n, 2)
    late = late.reshape(-1, n, 2)
    valid = valid.reshape(-1, n)
    key = key.reshape(-1, 2)
    num_valid = valid.sum(-1)
    # stable compaction: indices of valid points first
    order = torch.sort((~valid).to(torch.int32), dim=-1, stable=True).indices
    draws = sample_distinct4(key, iterations, num_valid)  # (B, iters, 4)
    sample_idx = torch.gather(order, 1, draws.reshape(draws.shape[0], -1))
    sample_idx = sample_idx.reshape(draws.shape)
    thr2 = threshold * threshold

    masks, counts = [], []
    for s in range(0, early.shape[0], _RANSAC_BLOCK):
        sl = slice(s, s + _RANSAC_BLOCK)
        idx = sample_idx[sl]
        flat = idx.reshape(idx.shape[0], -1, 1).expand(-1, -1, 2)
        se = torch.gather(early[sl], 1, flat).reshape(idx.shape + (2,))
        sl_ = torch.gather(late[sl], 1, flat).reshape(idx.shape + (2,))
        h_candidates = quad_to_quad_homography(se, sl_)
        m, c = _consensus(early[sl], late[sl], valid[sl], h_candidates, thr2)
        masks.append(m)
        counts.append(c)
    best_mask = torch.cat(masks)
    ok = (torch.cat(counts) >= 4) & (num_valid >= 4)

    h = estimate_homography(early, late, best_mask.to(early.dtype), refine_iterations)
    for _ in range(polish_rounds):
        err2 = ((apply_homography(h, early) - late) ** 2).sum(-1)
        new_mask = (err2 < thr2) & valid & _all_finite(h)[:, None]
        enough = new_mask.sum(-1) >= 4
        new_mask = torch.where(enough[:, None], new_mask, best_mask)
        h_n = estimate_homography(
            early, late, new_mask.to(early.dtype), refine_iterations
        )
        h = torch.where(_all_finite(h_n)[:, None, None], h_n, h)
        best_mask = new_mask

    identity = torch.eye(3, dtype=early.dtype, device=early.device)
    h = torch.where((ok & _all_finite(h))[:, None, None], h, identity)
    return (
        h.reshape(batch + (3, 3)),
        (best_mask & ok[:, None]).reshape(batch + (n,)),
        ok.reshape(batch),
    )
