"""PyTorch port: the LK fetch dispatcher (``kernels/lk_fetch.py``) and
kernel C's plain version against the JAX package's band-fetch Pallas
kernel (``meshflow_tpu/kernels/_lk_pallas_band.py``) in interpret mode.

The JAX dispatcher ``lk_pallas`` reads MESHFLOW_LK_FETCH once at import,
so the band module is imported directly and the variable is not set for
JAX.  The port's trackers read it at each call; on the CPU both routes
take ``lk_level_plain``.

Tolerance: the gate of tests/test_lk_pallas_interpret.py and
tests/test_torch_lk.py (status agreement > 0.97 on valid slots, p95
endpoint distance < 0.1 px, invalid slots untouched): the Pallas kernel
sums windows in another order and stops after 4 patch rounds, where the
port follows a feature over the whole plane, so endpoints agree to
float32 round-off over up to 10 iterations, not bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu.kernels import _lk_pallas_band as band
from meshflow_tpu.kernels.pyramid import build_pyramid as jax_pyramid

from meshflow_tpu_torch.kernels import lk_band_cuda, lk_cuda, lk_fetch
from meshflow_tpu_torch.kernels.lk import PAD, reflect_pad_level
from meshflow_tpu_torch.kernels.pyramid import build_pyramid, pyramid_shapes
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)


def _tiles(rng, f, s, c, th, tw, shifts):
    """Blurred-noise tiles shifted per frame: (F, S, C, th, tw) float32."""
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


def _case(rng, max_level=1):
    f, s, c, k, th, tw = 2, 1, 3, 64, 64, 64
    frames = _tiles(rng, f, s, c, th, tw, [(0, 0), (3, -5)])
    pts = np.stack(
        [rng.uniform(12, tw - 12, (f, s, k)), rng.uniform(12, th - 12, (f, s, k))], axis=-1
    ).astype(np.float32)
    valid = rng.random((f, s, k)) < 0.9
    planes = tuple(
        reflect_pad_level(x).to(torch.uint8) for x in build_pyramid(torch.from_numpy(frames), max_level)
    )
    jplanes = tuple(
        band.reflect_pad_level(x).astype(jnp.uint8)
        for x in jax_pyramid(jnp.asarray(frames), max_level)
    )
    return frames, pts, valid, planes, jplanes, tuple(pyramid_shapes(th, tw, max_level))


def test_planes_equal_band_data_region(rng):
    _, _, _, planes, jplanes, dims = _case(rng)
    for p, j, (rows, cols) in zip(planes, jplanes, dims):
        j = np.asarray(j)
        hdata, wdata = rows + 2 * PAD, cols + 2 * PAD
        assert p.shape[-2:] == (hdata, wdata)
        assert j.shape[-2] > hdata and j.shape[-1] > wdata  # aligned slack
        np.testing.assert_array_equal(p.numpy(), j[..., :hdata, :wdata])
        assert not j[..., hdata:, :].any() and not j[..., :, wdata:].any()


@pytest.mark.parametrize("shifted", [True, False])
def test_plain_matches_band_kernel_interpret(rng, monkeypatch, shifted):
    monkeypatch.setenv("MESHFLOW_LK_FETCH", "band")
    _, pts, valid, planes, jplanes, dims = _case(rng)
    iters = 10
    before = (lk_cuda.lk_level.launches, lk_band_cuda.lk_level_band.launches)
    if shifted:
        jp, jst = band.lk_track_pairs_pallas(
            jplanes, dims, jnp.asarray(pts), jnp.asarray(valid), max_iters=iters,
            interpret=True,
        )
        tp, tst = lk_cuda.lk_track_pairs(
            planes, dims, torch.from_numpy(pts), torch.from_numpy(valid), max_iters=iters
        )
        src = pts[:-1]
    else:
        # frame 0 into frame 1 as a second array, seeded near the known
        # shift like cv2's OPTFLOW_USE_INITIAL_FLOW
        init = pts[:1] + np.array([-5.0, 3.0], np.float32) * 0.8
        jp, jst = band.lk_track_parallel_pallas(
            tuple(p[:1] for p in jplanes), tuple(p[1:] for p in jplanes), dims,
            jnp.asarray(pts[:1]), jnp.asarray(valid[:1]), shifted=False,
            max_iters=iters, interpret=True, init_pts=jnp.asarray(init),
        )
        tp, tst = lk_cuda.lk_track_parallel(
            tuple(p[:1] for p in planes), tuple(p[1:] for p in planes), dims,
            torch.from_numpy(pts[:1]), torch.from_numpy(valid[:1]), shifted=False,
            max_iters=iters, init_pts=torch.from_numpy(init),
        )
        src = pts[:1]
    assert (lk_cuda.lk_level.launches, lk_band_cuda.lk_level_band.launches) == before
    jp, jst, tp, tst = np.asarray(jp), np.asarray(jst), tp.numpy(), tst.numpy()
    v = valid[: src.shape[0]]
    both = jst & tst
    assert (jst == tst)[v].mean() > 0.97
    assert both[v].mean() > 0.5
    assert np.quantile(np.linalg.norm(jp - tp, axis=-1)[both], 0.95) < 0.1
    invalid = ~v
    assert invalid.any()
    np.testing.assert_array_equal(tp[invalid], src[invalid])
    assert not tst[invalid].any()


@pytest.mark.parametrize("value", ["onehot", "band", " Band ", "ONEHOT", None])
def test_dispatcher_routes_cpu_tensors_to_plain(rng, monkeypatch, value):
    if value is None:
        monkeypatch.delenv("MESHFLOW_LK_FETCH", raising=False)
    else:
        monkeypatch.setenv("MESHFLOW_LK_FETCH", value)
    route = lk_fetch.fetch_route()
    assert route == ("onehot" if value is None else value.strip().lower())
    _, pts, valid, planes, _, dims = _case(rng)
    before = (lk_cuda.lk_level.launches, lk_band_cuda.lk_level_band.launches)
    got = lk_cuda.lk_track_pairs(planes, dims, torch.from_numpy(pts), torch.from_numpy(valid))
    want = lk_cuda.lk_track_pairs(
        planes, dims, torch.from_numpy(pts), torch.from_numpy(valid),
        level_fn=lk_cuda.lk_level_plain,
    )
    assert (lk_cuda.lk_level.launches, lk_band_cuda.lk_level_band.launches) == before == (0, 0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    top = lk_fetch.level_function(route, top=True)
    low = lk_fetch.level_function(route, top=False)
    if route == "onehot":
        assert top is low is lk_cuda.lk_level
    else:
        assert top.func is low.func is lk_band_cuda.lk_level_band
        assert (top.keywords["patch"], low.keywords["patch"]) == (72, 40)


@pytest.mark.parametrize("value", ["", "xla", "band2", "one hot"])
def test_dispatcher_rejects_other_values(rng, monkeypatch, value):
    monkeypatch.setenv("MESHFLOW_LK_FETCH", value)
    with pytest.raises(ValueError):
        lk_fetch.fetch_route()
    _, pts, valid, planes, _, dims = _case(rng)
    with pytest.raises(ValueError):
        lk_cuda.lk_track_pairs(planes, dims, torch.from_numpy(pts), torch.from_numpy(valid))


def test_band_wrapper_routes_and_checks(rng):
    _, pts, valid, planes, _, dims = _case(rng, max_level=0)
    args = (planes[0][:1], planes[0][1:], torch.from_numpy(pts[:1]) - 10.0,
            torch.from_numpy(pts[:1]) - 10.0, torch.from_numpy(valid[:1]),
            torch.from_numpy(valid[:1]))
    kw = dict(rows=dims[0][0], cols=dims[0][1], shifted=False, is_level0=True)
    got = lk_band_cuda.lk_level_band(*args, **kw, patch=lk_band_cuda.PN_TOP)
    want = lk_cuda.lk_level_plain(*args, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        lk_band_cuda.lk_level_band(*meta, **kw)
    assert lk_band_cuda.lk_level_band.launches == 0
