"""PyTorch port: the plain LK level (kernel A's twin) against the JAX
package's trackers, and the CPU routing of the kernel wrapper.

Oracles: the XLA tracker ``meshflow_tpu/kernels/lk.py`` (itself tested
against cv2.calcOpticalFlowPyrLK) and the Pallas kernel A in interpret
mode.  Both read the same pixels but sum windows in another order, and
the Pallas kernel re-fetches patches in rounds where the port iterates on
the whole plane, so endpoints agree to float32 round-off carried through
up to 30 iterations, not bit for bit:

* XLA tracker: status agreement >= 0.99, p99 endpoint distance <= 0.02 px;
* Pallas interpret: the gate of tests/test_lk_pallas_interpret.py (status
  agreement > 0.97, p95 < 0.1 px, invalid slots untouched).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu.kernels import lk as jax_lk
from meshflow_tpu.kernels import lk_pallas
from meshflow_tpu.kernels.pyramid import build_pyramid as jax_pyramid

from meshflow_tpu_torch.kernels import lk_cuda
from meshflow_tpu_torch.kernels.lk import reflect_pad_level
from meshflow_tpu_torch.kernels.pyramid import build_pyramid, pyramid_shapes
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)


def _trackable_tiles(rng, f, s, c, th, tw, shifts):
    """Blurred-noise tiles shifted per frame: (F, S, C, th, tw) float32
    (the pattern of tests/test_lk_pallas_interpret.py)."""
    base = rng.integers(0, 256, (c, th + 40, tw + 40)).astype(np.float32)
    for _ in range(2):
        for ax in (1, 2):
            base = 0.25 * np.roll(base, 1, ax) + 0.5 * base + 0.25 * np.roll(base, -1, ax)
    frames = np.zeros((f, s, c, th, tw), np.float32)
    for t, (dy, dx) in enumerate(shifts):
        for si in range(s):
            oy, ox = 15 + dy + 3 * si, 15 + dx - 2 * si
            frames[t, si] = base[:, oy : oy + th, ox : ox + tw]
    return np.round(frames).astype(np.uint8).astype(np.float32)


def _planes(frames, max_level):
    levels = build_pyramid(torch.from_numpy(frames), max_level)
    planes = tuple(reflect_pad_level(lvl).to(torch.uint8) for lvl in levels)
    th, tw = frames.shape[-2:]
    return planes, tuple(pyramid_shapes(th, tw, max_level))


def _points(rng, f, s, k, th, tw, margin):
    pts = np.stack(
        [rng.uniform(margin, tw - margin, (f, s, k)), rng.uniform(margin, th - margin, (f, s, k))],
        axis=-1,
    ).astype(np.float32)
    return pts, rng.random((f, s, k)) < 0.9


def test_plain_lk_matches_xla_tracker(rng):
    f, s, c, k, th, tw, max_level = 3, 2, 3, 64, 90, 160, 2
    frames = _trackable_tiles(rng, f, s, c, th, tw, [(0, 0), (3, -5), (-4, 2)])
    pts, valid = _points(rng, f, s, k, th, tw, 4)

    ref_pts = np.zeros((f - 1, s, k, 2), np.float32)
    ref_st = np.zeros((f - 1, s, k), bool)
    for t in range(f - 1):
        for si in range(s):
            lv = [tuple(jax_lk.prepare_level(x) for x in jax_pyramid(jnp.asarray(frames[t + d, si]), max_level))
                  for d in (0, 1)]
            p, st = jax_lk.lk_track(lv[0], lv[1], jnp.asarray(pts[t, si]), jnp.asarray(valid[t, si]))
            ref_pts[t, si] = np.asarray(p)
            ref_st[t, si] = np.asarray(st)

    planes, dims = _planes(frames, max_level)
    out, st = lk_cuda.lk_track_pairs(planes, dims, torch.from_numpy(pts), torch.from_numpy(valid))
    out, st = out.numpy(), st.numpy()
    v = valid[:-1]
    both = st & ref_st
    assert (st == ref_st)[v].mean() >= 0.99
    assert both[v].mean() > 0.5
    dist = np.linalg.norm(out - ref_pts, axis=-1)[both]
    assert np.quantile(dist, 0.99) <= 0.02, np.quantile(dist, 0.99)


@pytest.mark.parametrize("shifted,f,c,th,tw,max_level", [
    pytest.param(True, 2, 1, 64, 64, 1, id="True"),
    pytest.param(False, 2, 3, 64, 64, 1, id="False"),
    # a 3840x2160 clip's tiles: d=5 tracks at 768x432, 4x4 subframes of
    # 108x192, 3 levels; three pairs of BGR tiles
    pytest.param(True, 4, 3, 108, 192, 2, id="True-4K-tile"),
])
def test_plain_lk_matches_pallas_interpret(rng, shifted, f, c, th, tw, max_level):
    s, k, iters = 1, 16, 10
    frames = _trackable_tiles(rng, f, s, c, th, tw, [(0, 0), (3, -5), (-4, 2), (2, 6)][:f])
    pts, valid = _points(rng, f, s, k, th, tw, 12)
    jlevels = jax_pyramid(jnp.asarray(frames), max_level)
    jplanes = tuple(lk_pallas.reflect_pad_level(x).astype(jnp.uint8) for x in jlevels)
    planes, dims = _planes(frames, max_level)
    for a, b in zip(planes, jplanes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    if shifted:
        jp, jst = lk_pallas.lk_track_pairs_pallas(
            jplanes, dims, jnp.asarray(pts), jnp.asarray(valid), max_iters=iters,
            interpret=True,
        )
        tp, tst = lk_cuda.lk_track_pairs(
            planes, dims, torch.from_numpy(pts), torch.from_numpy(valid), max_iters=iters
        )
        src = pts[:-1]
    else:
        # parallel pairs: frame 0 tracked into frame 1 as a second array,
        # seeded at the known shift like cv2's OPTFLOW_USE_INITIAL_FLOW
        init = pts[:1] + np.array([-5.0, 3.0], np.float32) * 0.8
        sel = tuple(p[:1] for p in jplanes), tuple(p[1:] for p in jplanes)
        jp, jst = lk_pallas.lk_track_parallel_pallas(
            sel[0], sel[1], dims, jnp.asarray(pts[:1]), jnp.asarray(valid[:1]),
            shifted=False, max_iters=iters, interpret=True, init_pts=jnp.asarray(init),
        )
        tp, tst = lk_cuda.lk_track_parallel(
            tuple(p[:1] for p in planes), tuple(p[1:] for p in planes), dims,
            torch.from_numpy(pts[:1]), torch.from_numpy(valid[:1]), shifted=False,
            max_iters=iters, init_pts=torch.from_numpy(init),
        )
        src = pts[:1]
    jp, jst, tp, tst = np.asarray(jp), np.asarray(jst), tp.numpy(), tst.numpy()
    v = valid[: src.shape[0]]
    both = jst & tst
    assert (jst == tst)[v].mean() > 0.97
    assert both[v].any()
    assert np.quantile(np.linalg.norm(jp - tp, axis=-1)[both], 0.95) < 0.1
    invalid = ~v
    assert invalid.any()
    np.testing.assert_array_equal(tp[invalid], src[invalid])
    assert not tst[invalid].any()


def test_wrapper_routes_cpu_tensors_to_plain(rng):
    frames = _trackable_tiles(rng, 2, 1, 3, 48, 64, [(0, 0), (1, 2)])
    planes, dims = _planes(frames, 1)
    pts, valid = _points(rng, 2, 1, 8, 48, 64, 8)
    args = (planes[0][:1], planes[0][1:], torch.from_numpy(pts[:1]) - 10.0,
            torch.from_numpy(pts[:1]) - 10.0, torch.from_numpy(valid[:1]),
            torch.from_numpy(valid[:1]))
    before = lk_cuda.lk_level.launches
    got = lk_cuda.lk_level(*args, rows=dims[0][0], cols=dims[0][1], shifted=False,
                           is_level0=True)
    want = lk_cuda.lk_level_plain(*args, rows=dims[0][0], cols=dims[0][1],
                                  shifted=False, is_level0=True)
    assert lk_cuda.lk_level.launches == before == 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
