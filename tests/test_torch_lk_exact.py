"""PyTorch port: the exactness the LK kernels' loop (csrc/lk_common.cuh)
rests on, shown on the CPU in float32 with every product and sum a
separate, rounded operation (as the kernels run under --fmad=false).

The kernels must give the bits of the plain version's operations
(``_scharr``, ``_bilinear`` in meshflow_tpu_torch/kernels/lk.py) although
they evaluate them in another arrangement:

* an earlier kernel evaluated each window texel from its four bilinear
  corners (four Scharr pairs and four image taps per texel);
* the set-up keeps each support point's Scharr pair once, as an int16
  32x the derivative, staged over the last bytes of the channel's own
  window block while gx and gy are written in trips of 32 texels;
* integers become floats through their bit patterns, not I2F;
* texel (r, x)'s "column x+1" vertical lerp is texel (r, x+1)'s "column
  x" lerp, so a kernel may compute it once for both (the kernels keep four
  taps a texel, which the first test covers).

Each arrangement is emulated here and compared bit for bit (torch.equal)
with the plain version on seeded uint8 patches and fractional offsets.
"""

import numpy as np
import pytest
import torch

from meshflow_tpu_torch.kernels.lk import WIN, _bilinear, _scharr
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)

AREA = WIN * WIN
SUPPORT = WIN + 1
CH_FLOATS = 3 * AREA
SCHARR_OFFSET = CH_FLOATS * 4 - SUPPORT * SUPPORT * 4  # bytes, as lk_common.cuh


def _inputs(seed, n, c):
    """(n, C, 24, 24) uint8 patches as float32 and (n,) fractional offsets,
    with the edge offsets 0 and the largest float32 below 1 among them."""
    rng = np.random.default_rng(seed)
    patch = rng.integers(0, 256, (n, c, SUPPORT + 2, SUPPORT + 2)).astype(np.float32)
    f = rng.random((2, n)).astype(np.float32)
    f[:, 0] = 0.0
    f[:, 1] = np.nextafter(np.float32(1), np.float32(0))
    return torch.from_numpy(patch), torch.from_numpy(f[0]), torch.from_numpy(f[1])


def _scharr_at(p, dy, dx):
    """Scharr/32 of patches p at the 21x21 window corners offset (dy, dx):
    the earlier kernel's per-corner evaluation, in its order of operations."""
    def at(y, x):
        y0, x0 = 1 + dy + y, 1 + dx + x
        return p[:, :, y0 : y0 + WIN, x0 : x0 + WIN]

    gx = (3.0 * (at(-1, 1) - at(-1, -1)) + 10.0 * (at(0, 1) - at(0, -1))
          + 3.0 * (at(1, 1) - at(1, -1))) * (1.0 / 32.0)
    gy = (3.0 * (at(1, -1) - at(-1, -1)) + 10.0 * (at(1, 0) - at(-1, 0))
          + 3.0 * (at(1, 1) - at(-1, 1))) * (1.0 / 32.0)
    return gx, gy


def _corners(v00, v01, v10, v11, fy, fx):
    """The kernels' bilinear of four corner values."""
    fy, fx = fy[:, None, None, None], fx[:, None, None, None]
    lo = (1.0 - fy) * v00 + fy * v10
    hi = (1.0 - fy) * v01 + fy * v11
    return (1.0 - fx) * lo + fx * hi


def _scharr_int(p):
    """32x Scharr of uint8 patches at the 22x22 support, in integers."""
    q = p.to(torch.int32)
    n = SUPPORT

    def at(dy, dx):
        return q[:, :, 1 + dy : 1 + dy + n, 1 + dx : 1 + dx + n]

    gx = 3 * (at(-1, 1) - at(-1, -1)) + 10 * (at(0, 1) - at(0, -1)) + 3 * (at(1, 1) - at(1, -1))
    gy = 3 * (at(1, -1) - at(-1, -1)) + 10 * (at(1, 0) - at(-1, 0)) + 3 * (at(1, 1) - at(-1, 1))
    return gx, gy


@pytest.mark.parametrize("seed,c", [(0, 1), (1, 3), (2, 3)])
def test_four_corner_evaluation_equals_plain(seed, c):
    p, fy, fx = _inputs(seed, 64, c)
    corners = [_scharr_at(p, dy, dx) for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))]
    gx, gy = _scharr(p)
    for k, plain in enumerate((gx, gy)):
        got = _corners(*(g[k] for g in corners), fy, fx)
        assert torch.equal(got, _bilinear(plain, fy, fx))
    taps = [p[:, :, 1 + dy : 1 + dy + WIN, 1 + dx : 1 + dx + WIN]
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1))]
    assert torch.equal(_corners(*taps, fy, fx), _bilinear(p[:, :, 1:23, 1:23], fy, fx))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int16_scharr_times_a_32nd_is_the_plain_float(seed):
    p, _, _ = _inputs(seed, 64, 3)
    p[:3] = 0.0  # flat and step patches: exact zeros and the largest sums
    p[1, :, :, : SUPPORT // 2] = 255.0
    p[2, :, : SUPPORT // 2] = 255.0
    for exact, plain in zip(_scharr_int(p), _scharr(p)):
        assert int(exact.abs().max()) <= 4080
        stored = exact.to(torch.int16)
        assert torch.equal(stored.to(torch.int32), exact)
        assert torch.equal(stored.to(torch.float32) * (1.0 / 32.0), plain)
    assert int(_scharr_int(p)[0][1:3].abs().max()) == 4080


@pytest.mark.parametrize("base,scale,values", [
    (0x4B000000, 1.0, range(0, 256)),  # uint8 taps (lk::u8f)
    (0x48C00000, 1.0 / 32.0, range(-4080, 4081)),  # 32x Scharr sums (lk::unscale)
])
def test_integer_to_float_by_bit_pattern_is_exact(base, scale, values):
    """The kernels convert without I2F: the integer added to a float's bit
    pattern whose last mantissa place is worth `scale`, minus that float,
    equals the integer times `scale` in float32."""
    v = torch.tensor(list(values), dtype=torch.int32)
    got = (v + base).view(torch.float32) - torch.tensor(base, dtype=torch.int32).view(
        torch.float32)
    assert torch.equal(got, v.to(torch.float32) * scale)


@pytest.mark.parametrize("seed,c", [(0, 1), (1, 3), (3, 2)])
def test_shared_vertical_lerp_equals_plain(seed, c):
    """Column x+1's vertical lerp of texel (r, x) is column x's lerp of
    texel (r, x+1): same operands, same operations."""
    v, fy, _ = _inputs(seed, 16, c)
    v = v[:, :, :SUPPORT, :SUPPORT]  # next-image taps (n, C, 22, 22)
    wy = (1.0 - fy)[:, None, None, None]
    lerp = wy * v[:, :, :WIN, :] + fy[:, None, None, None] * v[:, :, 1:, :]  # (n, C, 21, 22)
    own_hi = wy * v[:, :, :WIN, 1:] + fy[:, None, None, None] * v[:, :, 1:, 1:]
    assert torch.equal(own_hi[..., :-1], lerp[..., 1:WIN])


def _staged_setup(patch, fy, fx, level_mask):
    """One slot's set-up as the kernels lay it out in a warp's shared
    memory: per channel a block of 3 * 441 float32 (gx, gy, image) whose
    last 1,936 bytes first hold the int16 Scharr pairs; gx and gy are
    written in trips of 32 texels (every lane of a trip reads, then
    writes), the image window after.  Returns the blocks and the lanes'
    gradient sums."""
    c = patch.shape[0]
    blocks = np.zeros((c, CH_FLOATS), np.float32)
    sums = np.zeros((3, 32), np.float32)
    gx_int, gy_int = (g[0].numpy() for g in _scharr_int(torch.from_numpy(patch)[None]))
    wy, wx = np.float32(1.0) - fy, np.float32(1.0) - fx

    def bil(v00, v01, v10, v11):
        return wx * (wy * v00 + fy * v10) + fx * (wy * v01 + fy * v11)

    for ch in range(c):
        block = blocks[ch]
        at = SCHARR_OFFSET // 2
        sch = block.view(np.int16)[at : at + 2 * SUPPORT * SUPPORT].reshape(-1, 2)
        sch[:, 0] = np.where(level_mask, gx_int[ch], 0).reshape(-1)
        sch[:, 1] = np.where(level_mask, gy_int[ch], 0).reshape(-1)
        first = ch * AREA
        for base in range(first & ~31, first + AREA, 32):
            j = np.arange(base, base + 32) - first
            lane = np.arange(32)
            live = (j >= 0) & (j < AREA)
            j, lane = j[live], lane[live]
            r, col = j // WIN, j % WIN
            q = [r * SUPPORT + col, r * SUPPORT + col + 1, (r + 1) * SUPPORT + col,
                 (r + 1) * SUPPORT + col + 1]
            g = [sch[k].astype(np.float32) * np.float32(1.0 / 32.0) for k in q]
            gx = bil(*(x[:, 0] for x in g))
            gy = bil(*(x[:, 1] for x in g))
            block[j], block[AREA + j] = gx, gy  # after every read of the trip
            sums[0, lane] += gx * gx
            sums[1, lane] += gx * gy
            sums[2, lane] += gy * gy
        r, col = np.divmod(np.arange(AREA), WIN)
        t = patch[ch]
        block[2 * AREA :] = bil(t[r + 1, col + 1], t[r + 1, col + 2], t[r + 2, col + 1],
                                t[r + 2, col + 2])
    return blocks, sums


@pytest.mark.parametrize("seed,c,edge", [(0, 1, None), (1, 3, None), (2, 3, (3, -2)),
                                         (3, 2, (-5, 7))])
def test_staged_setup_equals_plain(seed, c, edge):
    """gx, gy from the int16 Scharr staged in the window block's own bytes,
    and the image window, equal the plain version's frozen window; `edge`
    puts the level's first (row, column) inside the support, so Scharr is
    zero on the points outside it."""
    p, fy, fx = _inputs(seed, 4, c)
    ys = xs = torch.arange(SUPPORT)
    if edge is None:
        mask = torch.ones(SUPPORT, SUPPORT, dtype=torch.bool)
    else:
        mask = (ys[:, None] >= edge[0]) & (xs[None, :] >= edge[1])
    gx, gy = _scharr(p)
    m = mask.to(torch.float32)
    want = (_bilinear(gx * m, fy, fx), _bilinear(gy * m, fy, fx),
            _bilinear(p[:, :, 1:23, 1:23], fy, fx))
    for k in range(p.shape[0]):
        blocks, sums = _staged_setup(p[k].numpy(), fy[k].numpy(), fx[k].numpy(), mask.numpy())
        got = torch.from_numpy(blocks).reshape(c, 3, WIN, WIN)
        for i in range(3):
            assert torch.equal(got[:, i], want[i][k])
        # each lane's sums add its texels (i = lane, lane + 32, ...) in order
        flat_gx = want[0][k].reshape(-1).numpy()
        flat_gy = want[1][k].reshape(-1).numpy()
        for lane in (0, 13, 31):
            s = np.float32(0.0)
            for i in range(lane, c * AREA, 32):
                s += flat_gx[i] * flat_gy[i]
            assert s == sums[1, lane]
