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
backward-map kernel performs the plain version's float
operations in the same order without contraction, so coverage and crop
edges are equal and maps within 1e-4 px.
"""

import numpy as np
import pytest
import torch

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels import _build, bmap_cuda, lk_band_cuda, lk_cuda
from meshflow_tpu_torch.kernels.lk import reflect_pad_level
from meshflow_tpu_torch.kernels.pyramid import build_pyramid, pyramid_shapes
from meshflow_tpu_torch.render.stabilize import crop_edges
from meshflow_tpu_torch.utils import grid


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tiles(seed, f, s, c, th, tw, shifts, max_level=2):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (c, th + 80, tw + 80)).astype(np.float32)
    for _ in range(2):
        for ax in (1, 2):
            base = 0.25 * np.roll(base, 1, ax) + 0.5 * base + 0.25 * np.roll(base, -1, ax)
    frames = np.zeros((f, s, c, th, tw), np.float32)
    for t, (dy, dx) in enumerate(shifts):
        for si in range(s):
            oy, ox = 40 + dy + 3 * si, 40 + dx - 2 * si
            frames[t, si] = base[:, oy : oy + th, ox : ox + tw]
    frames = torch.from_numpy(np.round(frames))
    planes = tuple(
        reflect_pad_level(x).to(torch.uint8) for x in build_pyramid(frames, max_level)
    )
    pts = np.stack(
        [rng.uniform(4, tw - 4, (f, s, 128)), rng.uniform(4, th - 4, (f, s, 128))], axis=-1
    ).astype(np.float32)
    valid = rng.random((f, s, 128)) < 0.9
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


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "lib.so").exists()


def test_build_key_follows_sources():
    path = _build.library_path()
    assert path == _build.library_path()
    assert path.parent.parent == _build.BUILD_ROOT
    assert sorted(p.name for p in _build.SRC_DIR.glob("*.cu")) == [
        "bmap.cu", "lk_band.cu", "lk_level.cu"
    ]
    assert [p.name for p in _build.SRC_DIR.glob("*.cuh")] == ["lk_common.cuh"]


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


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mesh,h,w,scale", [(16, 360, 640, 1.5), (16, 360, 640, 12.0), (64, 1080, 1920, 3.0)]
)
def test_bmap_kernel_matches_plain_on_card(mesh, h, w, scale):
    dev = _card()
    config = MeshFlowConfig(mesh_row_count=mesh, mesh_col_count=mesh)
    rng = np.random.default_rng(mesh + int(scale))
    unstab = grid.vertex_grid(config, h, w, device=dev)
    stab = unstab + torch.from_numpy(
        rng.normal(0.0, scale, tuple(unstab.shape)).astype(np.float32)
    ).to(dev)
    before = bmap_cuda.backward_map.launches
    kb = bmap_cuda.backward_map(stab, unstab, config, h, w)
    pb = bmap_cuda.backward_map_plain(stab, unstab, config, h, w)
    assert bmap_cuda.backward_map.launches == before + 1
    assert torch.equal(kb.covered, pb.covered)
    cov = pb.covered
    assert (kb.map_x - pb.map_x)[cov].abs().max().item() <= 1e-4
    assert (kb.map_y - pb.map_y)[cov].abs().max().item() <= 1e-4
    assert torch.equal(crop_edges(kb, h, w), crop_edges(pb, h, w))
    # a batch of frames in one launch equals the frames one at a time
    batch = torch.stack([stab, unstab + 0.5 * (stab - unstab)])
    kbb = bmap_cuda.backward_map(batch, unstab, config, h, w)
    assert torch.equal(kbb.covered[0], kb.covered) and torch.equal(kbb.map_x[0], kb.map_x)
