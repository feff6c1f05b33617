"""PyTorch port: the hand-written CUDA kernels against their plain PyTorch
versions on the card, and the wrappers' routing rules everywhere.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without them; there the repository's conftest (which pins JAX to
the CPU) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tests marked ``cuda`` skip without a CUDA device.  Gates on the card: the
LK kernels sum their windows in another order than the plain version
(warp shuffles), so status agreement >= 0.99 and p99 endpoint distance
<= 0.02 px; kernel C computes kernel A's operations in kernel A's order
from a staged copy of the same bytes, so the two are bit-identical; the
backward-map kernel builds its cell table and maps each pixel with the
plain version's float operations in the same order without contraction
(tests/test_torch_bmap_exact.py shows the arrangement on the CPU), so its
maps, coverage and crop edges are equal to the plain version's.  The probe
kernels (D-G) move or select values without arithmetic, or (D's fine
select) sum in the plain version's order without contraction, so they
equal their plain versions bit for bit, D's fine select for any selection
matrix.
"""

import ctypes

import numpy as np
import pytest
import torch

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels import _build, _launch, bmap_cuda, lk_band_cuda, lk_cuda
from meshflow_tpu_torch.kernels.lk import reflect_pad_level
from meshflow_tpu_torch.kernels.pyramid import build_pyramid, pyramid_shapes
from meshflow_tpu_torch.probes import aligned_dynslice, dynslice_fetch, scalar_from_vmem, select_rows
from meshflow_tpu_torch.render.stabilize import crop_edges
from meshflow_tpu_torch.utils import grid


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tiles(seed, f, s, c, th, tw, shifts, max_level=2, k=128):
    """Blurred-noise tiles, tile si offset (3 si, -2 si) (s <= 4), or on a
    4-wide grid of (si % 4, -(si // 4)) offsets when s > 4."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (c, th + 80, tw + 80)).astype(np.float32)
    for _ in range(2):
        for ax in (1, 2):
            base = 0.25 * np.roll(base, 1, ax) + 0.5 * base + 0.25 * np.roll(base, -1, ax)
    frames = np.zeros((f, s, c, th, tw), np.float32)
    for t, (dy, dx) in enumerate(shifts):
        for si in range(s):
            oy, ox = (40 + dy + 3 * si, 40 + dx - 2 * si) if s <= 4 else (
                40 + dy + si % 4, 40 + dx - si // 4)
            frames[t, si] = base[:, oy : oy + th, ox : ox + tw]
    frames = torch.from_numpy(np.round(frames))
    planes = tuple(
        reflect_pad_level(x).to(torch.uint8) for x in build_pyramid(frames, max_level)
    )
    pts = np.stack(
        [rng.uniform(4, tw - 4, (f, s, k)), rng.uniform(4, th - 4, (f, s, k))], axis=-1
    ).astype(np.float32)
    valid = rng.random((f, s, k)) < 0.9
    dims = tuple(pyramid_shapes(th, tw, max_level))
    return planes, dims, torch.from_numpy(pts), torch.from_numpy(valid)


def test_wrappers_raise_for_tensors_off_cpu_and_cuda():
    planes, dims, pts, valid = _tiles(0, 2, 1, 3, 48, 64, [(0, 0), (1, 2)])
    meta = [t.to("meta") for t in (planes[0], planes[0], pts[:1], pts[:1], valid[:1], valid[:1])]
    with pytest.raises(ValueError):
        lk_cuda.lk_level(*meta, rows=dims[0][0], cols=dims[0][1])
    config = MeshFlowConfig()
    unstab = grid.vertex_grid(config, 48, 64)
    with pytest.raises(ValueError):
        bmap_cuda.backward_map(unstab.to("meta"), unstab.to("meta"), config, 48, 64)
    assert lk_cuda.lk_level.launches == 0 and bmap_cuda.backward_map.launches == 0


def test_probe_wrappers_route_by_device():
    """CPU tensors take the plain version without a launch; tensors on
    another device raise instead of falling back."""
    idx, plane = dynslice_fetch.probe_inputs(4)
    rsel = dynslice_fetch.one_hot_rsel(4)
    table, cells = select_rows.probe_inputs(48, bp=64)
    e_plane, r0 = aligned_dynslice.probe_inputs()
    g_plane, corners = scalar_from_vmem.probe_inputs()
    d, e, f, g = dynslice_fetch, aligned_dynslice, select_rows, scalar_from_vmem
    calls = [
        (d.dynslice_copy, d.dynslice_copy_plain, (idx, plane, 2)),
        (d.dynslice_fine, d.dynslice_fine_plain, (idx, plane, rsel, 2)),
        (d.onehot_rowsel, d.onehot_rowsel_plain, (idx, plane, 2)),
        (e.aligned_rows, e.aligned_rows_plain, (e_plane, r0)),
        (f.select_rows, f.select_rows_plain, (table, cells)),
        (g.band_row, g.band_row_plain, (g_plane, corners)),
    ]
    for fn, plain, args in calls:
        got, want = fn(*args), plain(*args)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b), fn.__name__
        with pytest.raises(ValueError):
            fn(*(a.to("meta") if isinstance(a, torch.Tensor) else a for a in args))
        assert fn.launches == 0, fn.__name__


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "lib.so").exists()


@pytest.mark.parametrize("fails", ["compile", "link"])
def test_failed_build_leaves_no_temporary_files(monkeypatch, tmp_path, fails):
    """A stand-in nvcc writes its output, then fails on one source (or at
    the link): build() raises and removes every object and partial library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        ': > "$out"\n'
        f'case "$*" in *{"bmap.cu" if fails == "compile" else "-shared"}*) exit 1;; esac\n'
    )
    nvcc.chmod(0o755)
    lib = tmp_path / "build" / "lib.so"
    monkeypatch.setattr(_build, "library_path", lambda: lib)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    with pytest.raises(RuntimeError, match="link failed" if fails == "link" else "nvcc failed"):
        _build.build()
    assert list(lib.parent.iterdir()) == []


def test_build_key_follows_sources():
    path = _build.library_path()
    assert path == _build.library_path()
    assert path.parent.parent == _build.BUILD_ROOT
    assert sorted(p.name for p in _build.SRC_DIR.glob("*.cu")) == [
        "bmap.cu", "lk_band.cu", "lk_level.cu", "probe_aligned_dynslice.cu",
        "probe_dynslice_fetch.cu", "probe_scalar_from_vmem.cu", "probe_select_rows.cu",
    ]
    assert sorted(p.name for p in _build.SRC_DIR.glob("*.cuh")) == ["lk_common.cuh", "probes.cuh"]


@pytest.mark.parametrize("value,kind", [
    (1e-4, float), (0.01 * 0.01, float), (3, int), (True, int), (False, int),
    (torch.zeros(4), ctypes.c_void_p),
])
def test_launch_arguments_keep_their_c_kind(value, kind):
    """Floats stay floats (an int() would make eps2 = 1e-4 a 0), ints and
    bools become ints, tensors their data pointers."""
    (got,) = _launch.c_args([value])
    assert type(got) is kind
    if kind is ctypes.c_void_p:
        assert got.value == value.data_ptr()
    else:
        assert got == value


def test_launch_calls_the_entry_point_with_the_stream_last(monkeypatch):
    calls = []

    class Library:
        def meshflow_lk_level(self, *args):
            calls.append(args)
            return 0

        def failing(self, *args):
            return 700

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(_launch, "stream_of", lambda device: "stream")
    t = torch.zeros(2)
    _launch.launch("meshflow_lk_level", torch.device("cpu"), t, 5, 1e-4, True)
    ((ptr, n, eps2, flag, stream),) = calls
    assert (ptr.value, n, eps2, flag, stream) == (t.data_ptr(), 5, 1e-4, 1, "stream")
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        _launch.launch("failing", torch.device("cpu"))


def _motion_block():
    """The main path's motion launch shape: 63 pairs of 16 tiles of
    90x160x3 (640x360 frames), 512 slots a tile, 3 levels."""
    rng = np.random.default_rng(7)
    shifts = [(0, 0)] + [tuple(int(v) for v in rng.integers(-6, 7, 2)) for _ in range(63)]
    return _tiles(7, 64, 16, 3, 90, 160, shifts, k=512)


@pytest.fixture(scope="module")
def motion_block():
    dev = _card()
    planes, dims, pts, valid = _motion_block()
    return tuple(p.to(dev) for p in planes), dims, pts.to(dev), valid.to(dev)


def _lk_gates(kp, kst, pp, pst, pts, valid):
    assert (kst == pst)[valid].float().mean().item() >= 0.99
    both = kst & pst
    assert torch.quantile(torch.linalg.norm(kp - pp, dim=-1)[both], 0.99).item() <= 0.02
    assert torch.equal(kp[~valid], pts[~valid]) and not kst[~valid].any()


@pytest.mark.cuda
def test_lk_kernel_matches_plain_at_the_motion_launch_on_card(motion_block):
    planes, dims, pts, valid = motion_block
    kp, kst = lk_cuda.lk_track_pairs(planes, dims, pts, valid, level_fn=lk_cuda.lk_level)
    pp, pst = lk_cuda.lk_track_pairs(planes, dims, pts, valid, level_fn=lk_cuda.lk_level_plain)
    _lk_gates(kp, kst, pp, pst, pts[:-1], valid[:-1])


@pytest.mark.cuda
def test_lk_kernel_unshifted_with_init_pts_on_card(motion_block):
    """The metric pass's launch: frame t of one pyramid against frame t of
    another (shifted=False), started at init_pts."""
    planes, dims, pts, valid = motion_block
    prev, nxt = tuple(p[:-1] for p in planes), tuple(p[1:] for p in planes)
    init = pts[:-1] + 0.5

    def run(fn):
        return lk_cuda.lk_track_parallel(prev, nxt, dims, pts[:-1], valid[:-1],
                                         init_pts=init, level_fn=fn)

    _lk_gates(*run(lk_cuda.lk_level), *run(lk_cuda.lk_level_plain), pts[:-1], valid[:-1])


@pytest.mark.cuda
def test_band_kernel_bit_identical_to_kernel_a_at_the_motion_launch_on_card(
    monkeypatch, motion_block
):
    planes, dims, pts, valid = motion_block
    ap, ast = lk_cuda.lk_track_pairs(planes, dims, pts, valid, level_fn=lk_cuda.lk_level)
    monkeypatch.setenv("MESHFLOW_LK_FETCH", "band")
    cp, cst = lk_cuda.lk_track_pairs(planes, dims, pts, valid)
    assert torch.equal(cp, ap) and torch.equal(cst, ast)


@pytest.mark.cuda
@pytest.mark.parametrize("level_fn", [lk_cuda.lk_level, lk_band_cuda.lk_level_band])
def test_lk_launches_in_a_row_give_equal_results_on_card(motion_block, level_fn):
    """Each launch starts its own work counter at 0: two launches queued
    back to back on one stream track every slot."""
    planes, dims, pts, valid = motion_block
    args = (planes[0], planes[0], pts[:-1] - 10.0, pts[:-1] - 10.0, valid[:-1], valid[:-1])
    first = level_fn(*args, rows=dims[0][0], cols=dims[0][1])
    second = level_fn(*args, rows=dims[0][0], cols=dims[0][1])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert not torch.equal(first[0][valid[:-1]], args[3][valid[:-1]])


@pytest.mark.cuda
def test_lk_kernel_matches_plain_on_card():
    dev = _card()
    planes, dims, pts, valid = _tiles(1, 3, 4, 3, 90, 160, [(0, 0), (3, -5), (-4, 2)])
    planes = tuple(p.to(dev) for p in planes)
    pts, valid = pts.to(dev), valid.to(dev)
    before = lk_cuda.lk_level.launches
    kp, kst = lk_cuda.lk_track_pairs(planes, dims, pts, valid)
    pp, pst = lk_cuda.lk_track_pairs(planes, dims, pts, valid, level_fn=lk_cuda.lk_level_plain)
    assert lk_cuda.lk_level.launches == before + 3
    v = valid[:-1]
    assert (kst == pst)[v].float().mean().item() >= 0.99
    both = kst & pst
    assert torch.quantile(torch.linalg.norm(kp - pp, dim=-1)[both], 0.99).item() <= 0.02
    assert torch.equal(kp[~v], pts[:-1][~v]) and not kst[~v].any()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "th,tw,max_level,shifts",
    [(90, 160, 2, [(0, 0), (3, -5), (-4, 2)]), (270, 480, 3, [(0, 0), (18, -20), (-12, 9)])],
)
def test_band_kernel_matches_plain_and_kernel_a_on_card(monkeypatch, th, tw, max_level, shifts):
    dev = _card()
    planes, dims, pts, valid = _tiles(2, 3, 4, 3, th, tw, shifts, max_level)
    planes = tuple(p.to(dev) for p in planes)
    pts, valid = pts.to(dev), valid.to(dev)
    monkeypatch.setenv("MESHFLOW_LK_FETCH", "band")
    before = (lk_band_cuda.lk_level_band.launches, lk_cuda.lk_level.launches)
    cp, cst = lk_cuda.lk_track_pairs(planes, dims, pts, valid)
    assert (lk_band_cuda.lk_level_band.launches, lk_cuda.lk_level.launches) == (
        before[0] + max_level + 1, before[1]
    )
    ap, ast = lk_cuda.lk_track_pairs(planes, dims, pts, valid, level_fn=lk_cuda.lk_level)
    pp, pst = lk_cuda.lk_track_pairs(planes, dims, pts, valid, level_fn=lk_cuda.lk_level_plain)
    assert torch.equal(cp, ap) and torch.equal(cst, ast)
    v = valid[:-1]
    assert (cst == pst)[v].float().mean().item() >= 0.99
    both = cst & pst
    assert torch.quantile(torch.linalg.norm(cp - pp, dim=-1)[both], 0.99).item() <= 0.02
    assert torch.equal(cp[~v], pts[:-1][~v]) and not cst[~v].any()


def _bmap_inputs(dev, mesh, h, w, scale, frames=None, degenerate=False):
    config = MeshFlowConfig(mesh_row_count=mesh, mesh_col_count=mesh)
    rng = np.random.default_rng(mesh + int(scale))
    unstab = grid.vertex_grid(config, h, w)
    shape = tuple(unstab.shape) if frames is None else (frames,) + tuple(unstab.shape)
    stab = unstab + torch.from_numpy(rng.normal(0.0, scale, shape).astype(np.float32))
    if degenerate:
        from test_torch_bmap_exact import _degenerate

        stab = _degenerate(stab, rng)
    return config, stab.to(dev), unstab.to(dev)


def _assert_bmap_equal(kb, pb, h, w):
    assert torch.equal(kb.covered, pb.covered)
    assert torch.equal(kb.map_x, pb.map_x) and torch.equal(kb.map_y, pb.map_y)
    assert torch.equal(crop_edges(kb, h, w), crop_edges(pb, h, w))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mesh,h,w,scale", [(16, 360, 640, 1.5), (16, 360, 640, 12.0), (64, 1080, 1920, 3.0)]
)
def test_bmap_kernel_matches_plain_on_card(mesh, h, w, scale):
    config, stab, unstab = _bmap_inputs(_card(), mesh, h, w, scale)
    before = bmap_cuda.backward_map.launches
    kb = bmap_cuda.backward_map(stab, unstab, config, h, w)
    pb = bmap_cuda.backward_map_plain(stab, unstab, config, h, w)
    assert bmap_cuda.backward_map.launches == before + 1
    _assert_bmap_equal(kb, pb, h, w)
    # a batch of frames in one launch equals the frames one at a time
    batch = torch.stack([stab, unstab + 0.5 * (stab - unstab)])
    kbb = bmap_cuda.backward_map(batch, unstab, config, h, w)
    assert torch.equal(kbb.covered[0], kb.covered) and torch.equal(kbb.map_x[0], kb.map_x)


@pytest.mark.cuda
@pytest.mark.parametrize("mesh,h,w,scale,frames,degenerate", [
    (64, 1080, 1920, 3.0, 3, False),  # a 64x64 batch: the table read through L1
    (16, 360, 640, 3.0, 4, True),  # collapsed and far-outside vertices
    (64, 61, 97, 0.7, 2, True),  # repeated grid lines (H - 1 < 64), odd width
])
def test_bmap_kernel_batches_match_plain_on_card(mesh, h, w, scale, frames, degenerate):
    config, stab, unstab = _bmap_inputs(_card(), mesh, h, w, scale, frames, degenerate)
    kb = bmap_cuda.backward_map(stab, unstab, config, h, w)
    pb = bmap_cuda.backward_map_plain(stab, unstab, config, h, w)
    _assert_bmap_equal(kb, pb, h, w)
    if degenerate:
        assert not pb.covered.all()


@pytest.mark.cuda
def test_bmap_call_is_one_launch_after_allocations_only_on_card(monkeypatch):
    """One backward_map call on CUDA tensors: the PyTorch ops it dispatches
    are the allocations of its outputs and table workspace, all before its
    one call of the entry point."""
    from torch.utils._python_dispatch import TorchDispatchMode

    config, stab, unstab = _bmap_inputs(_card(), 16, 360, 640, 1.5, frames=8)
    events = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            events.append(str(func))
            return func(*args, **(kwargs or {}))

    launch = _launch.launch
    monkeypatch.setattr(_launch, "launch", lambda *a: (events.append(a[0]), launch(*a))[1])
    bmap_cuda.backward_map(stab, unstab, config, 360, 640)  # the library is loaded
    before = bmap_cuda.backward_map.launches
    events.clear()
    with Ops():
        bmap_cuda.backward_map(stab, unstab, config, 360, 640)
    assert events == ["aten.empty.memory_format"] * 4 + ["meshflow_bmap"]
    assert bmap_cuda.backward_map.launches == before + 1


def _equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 2, 5])
@pytest.mark.parametrize("b", [4, 16, 64, 128])
def test_probe_d_kernels_match_plain_on_card(b, reps):
    """Bit for bit, the fine select too on a random rsel: its sums keep the
    plain version's k order and separate multiply and add.  reps 1, 2
    and 5 cover one round and both of its band buffers."""
    dev = _card()
    idx, plane = (t.to(dev) for t in dynslice_fetch.probe_inputs(b))
    idx[:4] = torch.tensor([320, 640, -16, -100], dtype=torch.int32)  # clamped and wrapped
    d = dynslice_fetch
    before = (d.dynslice_copy.launches, d.dynslice_fine.launches, d.onehot_rowsel.launches)
    assert _equal(d.dynslice_copy(idx, plane, reps), d.dynslice_copy_plain(idx, plane, reps))
    rsel = d.one_hot_rsel(b, seed=1).to(dev)
    assert _equal(d.dynslice_fine(idx, plane, rsel, reps),
                  d.dynslice_fine_plain(idx, plane, rsel, reps))
    rsel = torch.from_numpy(np.random.default_rng(1).random((b, d.PN, d.BAND_R), np.float32)).to(dev)
    assert _equal(d.dynslice_fine(idx, plane, rsel, reps),
                  d.dynslice_fine_plain(idx, plane, rsel, reps))
    for first in (idx[0].item(), 300):
        idx[0] = first  # 300: rows past the plane select zeros
        assert _equal(d.onehot_rowsel(idx, plane, reps), d.onehot_rowsel_plain(idx, plane, reps))
    torch.cuda.synchronize()
    assert (d.dynslice_copy.launches, d.dynslice_fine.launches, d.onehot_rowsel.launches) == (
        before[0] + 1, before[1] + 2, before[2] + 2
    )


@pytest.mark.cuda
@pytest.mark.parametrize("w", [4, 256, 664, 1024])
def test_probe_e_kernel_matches_plain_on_card(w):
    """Every start of the plane, wrapped ones too, at widths past the 512
    that the earlier kernel's shared memory allowed."""
    dev = _card()
    h = aligned_dynslice.H
    plane = torch.arange(h * w, dtype=torch.float32, device=dev).reshape(h, w)
    before = aligned_dynslice.aligned_rows.launches
    for row in range(-3, h):
        r0 = torch.tensor([row], dtype=torch.int32, device=dev)
        got = aligned_dynslice.aligned_rows(plane, r0)
        assert torch.equal(got, aligned_dynslice.aligned_rows_plain(plane, r0)), row
    assert aligned_dynslice.aligned_rows.launches == before + h + 3


@pytest.mark.cuda
@pytest.mark.parametrize("nrows", [48, 144, 432])
def test_probe_f_kernel_is_exact_on_card(nrows):
    dev = _card()
    table, cells = (t.to(dev) for t in select_rows.probe_inputs(nrows))
    cells[0, :3] = torch.tensor([-1, 256, 255], dtype=torch.int32)  # outside the table: zeros
    got = select_rows.select_rows(table, cells)
    assert torch.equal(got, select_rows.select_rows_plain(table, cells))


@pytest.mark.cuda
def test_probe_f_kernel_is_exact_on_general_float32_on_card():
    """Every float32 bit pattern (NaN, inf, subnormals, -0.0) comes back as
    it is, compared as bits; K and N beyond the probe's."""
    dev = _card()
    _, cells = select_rows.probe_inputs(432)
    wide = cells[:, :1212] * 4  # K 1100, N 1212, 37 rows (a partial strip)
    wide[0, :2] = torch.tensor([-5, 1100], dtype=torch.int32)
    for table, cells in ((select_rows.general_table(432), cells),
                         (select_rows.general_table(37, cells_pad=1100), wide)):
        table, cells = table.to(dev), cells.to(dev)
        got = select_rows.select_rows(table, cells)
        want = select_rows.select_rows_plain(table, cells)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_probe_g_kernel_matches_plain_on_card():
    dev = _card()
    plane, _ = (t.to(dev) for t in scalar_from_vmem.probe_inputs())
    corners = scalar_from_vmem.corners_from([0.0, 3.7, 20.0, 24.0, 27.0, 31.4, -1.2, 10.0]).to(dev)
    got = scalar_from_vmem.band_row(plane, corners)
    assert torch.equal(got, scalar_from_vmem.band_row_plain(plane, corners))
    assert torch.equal(got[:, 0], plane[[0, 8, 40, 48, 48, 48, 48, 16]])
