"""PyTorch port: the exactness the render kernels (csrc/render.cu) rest
on, shown on the CPU in float32 with every product, sum and division a
separate, correctly rounded operation (as the kernels run under
--fmad=false with IEEE division), and the kernels on the card.

The kernels must give the bits of the plain versions
(``warp_frame_plain`` and ``crop_resize_frame_plain`` in
meshflow_tpu_torch/render/stabilize.py) although they arrange the work
otherwise:

* the kernels make a byte a float, and a sum a byte, by exact additions of
  2^23: shown for every byte and for sums around every half;
* ``warp_kernel`` takes an uncovered pixel's border colour without
  sampling, and a covered pixel's four taps in the order (0,0), (0,1),
  (1,0), (1,1), each weight one product, a tap outside the frame reading
  the border, summed from 0: emulated here pixel by pixel and held
  against ``warp_frame`` on the CPU (the plain version);
* ``crop_kernel`` computes each output pixel's taps from the crop read on
  the card (scale crop_w / W by IEEE division) and lerps its rows, then
  its columns: emulated and held against ``crop_resize_frame``;
* a launch's threads each take RUN pixels of one row, BLOCK_X apart
  (the lanes of a warp neighbouring pixels): every pixel of every frame is
  written exactly once.

The tests marked ``cuda`` hold the kernels on the card against the plain
versions on the CPU, inside a CUDA graph too, count their launches and run
the render under ``torch.cuda.set_sync_debug_mode("error")``.  This file
imports neither JAX nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_render_exact.py
"""

import re

import numpy as np
import pytest
import torch

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels import _build, bmap_cuda, render_cuda
from meshflow_tpu_torch.render import stabilize
from meshflow_tpu_torch.render.stabilize import BackwardMap
from meshflow_tpu_torch.utils import grid
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)

F32 = np.float32
CONFIG = MeshFlowConfig(color_outside_image_area_bgr=(17, 200, 255))

# csrc/render.cu's launch shape
RUN, BLOCK_X, BLOCK_Y = (
    int(re.search(rf"constexpr int {name} = (\d+);", _build.SRC_DIR.joinpath("render.cu")
                  .read_text()).group(1)) for name in ("RUN", "BLOCK_X", "BLOCK_Y"))


def _frame(rng, h, w, c):
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


def _maps(rng, h, w):
    """Maps of an (h, w) frame that take every branch of the warp: random
    points inside (-1, W) x (-1, H), whole and half pixels (rounding ties),
    taps on each edge and at -1, the corners, and uncovered pixels at the
    sentinel (W+1, H+1)."""
    low = np.nextafter(F32(-1), F32(0))
    mx = np.clip(rng.uniform(-1, w, (h, w)).astype(F32), low, np.nextafter(F32(w), F32(0)))
    my = np.clip(rng.uniform(-1, h, (h, w)).astype(F32), low, np.nextafter(F32(h), F32(0)))
    k = rng.integers(0, 8, (h, w))
    xs = rng.integers(-1, w, (h, w)).astype(F32)
    ys = rng.integers(-1, h, (h, w)).astype(F32)
    mx = np.where(k == 1, xs, mx)
    my = np.where(k == 1, ys, my)
    mx = np.where(k == 2, xs + F32(0.5), mx)
    my = np.where(k == 2, ys + F32(0.5), my)
    edge_x = np.array([low, F32(-0.25), F32(0), F32(w - 1),
                       F32(w - 1) + F32(0.75), np.nextafter(F32(w), F32(0))], F32)
    edge_y = np.array([low, F32(-0.5), F32(0), F32(h - 1),
                       F32(h - 1) + F32(0.5), np.nextafter(F32(h), F32(0))], F32)
    mx = np.where(k == 3, rng.choice(edge_x, (h, w)), mx)
    my = np.where(k == 4, rng.choice(edge_y, (h, w)), my)
    corner = k == 5
    mx = np.where(corner, rng.choice(edge_x[[0, -1]], (h, w)), mx)
    my = np.where(corner, rng.choice(edge_y[[0, -1]], (h, w)), my)
    covered = k != 6
    mx = np.where(covered, mx, F32(w + 1))
    my = np.where(covered, my, F32(h + 1))
    return mx.astype(F32), my.astype(F32), covered


TWO_23 = F32(2**23)


def _u8_to_f32(b):
    """u8_to_f32: the float with 2^23's bits and b in the low byte, less
    2^23."""
    return (np.uint32(0x4B000000) | b.astype(np.uint32)).view(F32) - TWO_23


def _to_u8(v):
    """to_u8: clamped to [0, 255], plus 2^23, the low byte of the bits."""
    bits = (np.minimum(np.maximum(v, F32(0)), F32(255)) + TWO_23).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8)


def test_bytes_and_floats_convert_exactly_by_two_to_the_23():
    b = np.arange(256, dtype=np.uint8)
    assert (_u8_to_f32(b) == b.astype(F32)).all()
    halves = np.arange(-4, 262, 0.5, dtype=F32)
    rng = np.random.default_rng(0)
    v = np.concatenate([halves, np.nextafter(halves, F32(-1e9)), np.nextafter(halves, F32(1e9)),
                        rng.uniform(-10, 300, 100_000).astype(F32),
                        np.array([-0.0, 1e30, -1e30, 254.5, 255.5, 256.5], F32)])
    want = torch.clamp(torch.round(torch.from_numpy(v)), 0, 255).to(torch.uint8)
    assert torch.equal(torch.from_numpy(_to_u8(v)), want)


def _warp_emulated(frame, mx, my, covered, border):
    """warp_kernel's operations on one frame in numpy float32."""
    h, w, c = frame.shape
    border = np.asarray(border, F32)
    one = F32(1)
    x0 = np.floor(np.where(covered, mx, F32(0)))
    y0 = np.floor(np.where(covered, my, F32(0)))
    fx = np.where(covered, mx, F32(0)) - x0
    fy = np.where(covered, my, F32(0)) - y0
    tx0, ty0 = x0.astype(np.int64), y0.astype(np.int64)
    acc = np.where(covered[..., None], F32(0), border).astype(F32)
    for dy in (0, 1):
        for dx in (0, 1):
            weight = (fx if dx else one - fx) * (fy if dy else one - fy)
            tx, ty = tx0 + dx, ty0 + dy
            inside = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)
            taps = _u8_to_f32(frame[np.clip(ty, 0, h - 1), np.clip(tx, 0, w - 1)])
            taps = np.where(inside[..., None], taps, border)
            acc = np.where(covered[..., None], acc + weight[..., None] * taps, acc)
    assert acc.dtype == F32
    return _to_u8(acc)


def _axis_emulated(n, extent, start):
    """crop_kernel's axis_taps for every output index of an n-pixel axis."""
    scale = extent / F32(n)
    s = (np.arange(n, dtype=F32) + F32(0.5)) * scale - F32(0.5)
    s = np.minimum(np.maximum(s, F32(0)), extent - F32(1)) + start
    s0 = np.floor(s)
    k = s0.astype(np.int64)
    return np.clip(k, 0, n - 1), np.clip(np.minimum(k + 1, n - 1), 0, n - 1), s - s0


def _crop_emulated(frame, crop):
    """crop_kernel's operations on one frame in numpy float32."""
    h, w, _ = frame.shape
    left, top, right, bottom = (F32(v) for v in crop)
    r0, r1, fy = _axis_emulated(h, (bottom - top) + F32(1), top)
    c0, c1, fx = _axis_emulated(w, (right - left) + F32(1), left)
    img = _u8_to_f32(frame)

    def lerp(a, b, f):
        return (F32(1) - f) * a + f * b

    fy = fy[:, None, None]
    a = lerp(img[r0][:, c0], img[r1][:, c0], fy)
    b = lerp(img[r0][:, c1], img[r1][:, c1], fy)
    out = lerp(a, b, fx[None, :, None])
    assert out.dtype == F32
    return _to_u8(out)


GEOMETRIES = [(37, 53), (360, 640)]


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_warp_emulation_equals_warp_frame(h, w, channels):
    rng = np.random.default_rng(h * 7 + w + channels)
    frame = _frame(rng, h, w, channels)
    mx, my, covered = _maps(rng, h, w)
    border = stabilize.border_color(CONFIG, channels)
    want = stabilize.warp_frame(
        torch.from_numpy(frame),
        BackwardMap(torch.from_numpy(mx), torch.from_numpy(my), torch.from_numpy(covered)),
        border,
    )
    got = _warp_emulated(frame, mx, my, covered, border)
    assert torch.equal(torch.from_numpy(got), want)
    assert (~covered).any() and (got[~covered] == np.asarray(border, np.uint8)).all()


CROPS = {
    "full": lambda h, w: (0, 0, w - 1, h - 1),
    "left and top edges": lambda h, w: (0, 0, w - 6, h - 4),
    "right and bottom edges": lambda h, w: (5, 3, w - 1, h - 1),
    "inside": lambda h, w: (w // 9, h // 7, w - w // 5 - 1, h - h // 6 - 1),
    "one pixel": lambda h, w: (w // 2, h // 2, w // 2, h // 2),
    "one pixel in a corner": lambda h, w: (w - 1, h - 1, w - 1, h - 1),
}


@pytest.mark.parametrize("crop_name", list(CROPS))
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_crop_emulation_equals_crop_resize_frame(h, w, channels, crop_name):
    rng = np.random.default_rng(h + w * 3 + channels)
    frame = _frame(rng, h, w, channels)
    crop = CROPS[crop_name](h, w)
    dtype = torch.int32 if channels == 1 else torch.int64  # the online crop is int32
    want = stabilize.crop_resize_frame(torch.from_numpy(frame), torch.tensor(crop, dtype=dtype),
                                       h, w)
    assert torch.equal(torch.from_numpy(_crop_emulated(frame, crop)), want)


@pytest.mark.parametrize("f,h,w", [(64, 360, 640), (2, 1080, 1920), (3, 37, 53), (1, 1, 1),
                                   (5, 9, 6), (1, 2160, 3840)])
def test_a_launch_writes_every_pixel_once(f, h, w):
    """grid_of and row_of: the pixels of all threads, x0 + k BLOCK_X for k
    < RUN up to the row's end, cover each pixel of each frame once."""
    grid = ((w + BLOCK_X * RUN - 1) // (BLOCK_X * RUN), (h + BLOCK_Y - 1) // BLOCK_Y, f)
    assert grid[2] <= render_cuda.MAX_FRAMES
    bx, tx = np.meshgrid(np.arange(grid[0]), np.arange(BLOCK_X), indexing="ij")
    x0 = (bx * BLOCK_X * RUN + tx).ravel()
    by, ty = np.meshgrid(np.arange(grid[1]), np.arange(BLOCK_Y), indexing="ij")
    y = (by * BLOCK_Y + ty).ravel()
    written = np.zeros(w, np.int64)
    for k in range(RUN):
        x = x0 + k * BLOCK_X
        np.add.at(written, x[x < w], 1)
    assert (written == 1).all()
    assert sorted(y[y < h].tolist()) == list(range(h))


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU the block entry points are the plain versions a frame at
    a time, and never load the kernel library."""
    def no_library():
        raise AssertionError("the CPU route loaded the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    rng = np.random.default_rng(3)
    frames = torch.from_numpy(np.stack([_frame(rng, 37, 53, 3) for _ in range(3)]))
    maps = [_maps(rng, 37, 53) for _ in range(3)]
    bmap = BackwardMap(*(torch.from_numpy(np.stack(m)) for m in zip(*maps)))
    crop = torch.tensor([2, 1, 50, 33])
    launches = (render_cuda.warp.launches, render_cuda.crop_resize.launches)
    warped = stabilize.warp_block(frames, bmap, CONFIG)
    cropped = stabilize.crop_frames(warped, crop, 37, 53)
    border = stabilize.border_color(CONFIG, 3)
    for i in range(3):
        one = stabilize.warp_frame_plain(frames[i], BackwardMap(*(m[i] for m in bmap)), border)
        assert torch.equal(warped[i], one)
        assert torch.equal(cropped[i], stabilize.crop_resize_frame_plain(one, crop, 37, 53))
    assert (render_cuda.warp.launches, render_cuda.crop_resize.launches) == launches


def test_wrappers_raise_for_tensors_off_cpu_and_cuda():
    frames = torch.zeros(2, 6, 8, 3, dtype=torch.uint8, device="meta")
    bmap = BackwardMap(torch.zeros(2, 6, 8, device="meta"), torch.zeros(2, 6, 8, device="meta"),
                       torch.zeros(2, 6, 8, dtype=torch.bool, device="meta"))
    crop = torch.zeros(4, dtype=torch.int64, device="meta")
    launches = (render_cuda.warp.launches, render_cuda.crop_resize.launches)
    with pytest.raises(ValueError, match="CUDA"):
        render_cuda.warp(frames, bmap, [0, 0, 0])
    with pytest.raises(ValueError, match="CUDA"):
        render_cuda.crop_resize(frames, crop, 6, 8)
    with pytest.raises(ValueError, match="1 or 3"):
        render_cuda.crop_resize(frames[..., :2], crop, 6, 8)
    assert (render_cuda.warp.launches, render_cuda.crop_resize.launches) == launches


# --- on the card -------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _block(dev, frames, h, w, channels, seed):
    """Seeded frames (F, H, W, C) on `dev` and their backward maps from
    kernel B: a mesh panned by a few pixels with jittered vertices, so that
    some pixels are uncovered and some taps fall outside the frame."""
    rng = np.random.default_rng(seed)
    config = MeshFlowConfig()
    unstab = grid.vertex_grid(config, h, w, device=dev)
    shift = rng.uniform(-8, 8, (frames, 1, 1, 2))
    jitter = rng.normal(0.0, 3.0, (frames,) + tuple(unstab.shape))
    stab = unstab + torch.from_numpy((shift + jitter).astype(F32)).to(dev)
    bmap = bmap_cuda.backward_map(stab, unstab, config, h, w)
    block = torch.from_numpy(rng.integers(0, 256, (frames, h, w, channels), dtype=np.uint8))
    return block.to(dev), bmap


CARD_CASES = {
    "640x360 block": (64, 360, 640, 3),
    "1080p block": (16, 1080, 1920, 3),
    "gray track planes": (64, 360, 640, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES) + ["online frame"])
def test_kernels_equal_plain_on_card(case):
    """Each kernel torch.equal to its plain version on the CPU: blocks
    through warp_block and crop_frames (the crop of block_crop, int64), one
    online frame through warp_frame and crop_resize_frame (the fixed online
    crop, int32)."""
    from meshflow_tpu_torch import online

    dev = _card()
    if case == "online frame":
        frames, bmap = _block(dev, 1, 360, 640, 3, seed=7)
        frame, bmap = frames[0], BackwardMap(*(m[0] for m in bmap))
        consts = online.online_constants(MeshFlowConfig(), 360, 640, 0.8, dev)
        border = stabilize.border_color(CONFIG, 3)
        warped = stabilize.warp_frame(frame, bmap, border)
        cropped = stabilize.crop_resize_frame(warped, consts.crop, 360, 640)
        crop = consts.crop
    else:
        f, h, w, c = CARD_CASES[case]
        frame, bmap = _block(dev, f, h, w, c, seed=f + h + c)
        border = stabilize.border_color(CONFIG, c)
        warped = stabilize.warp_block(frame, bmap, CONFIG)
        crop = stabilize.block_crop(bmap, h, w)
        cropped = stabilize.crop_frames(warped, crop, h, w)
    h, w = frame.shape[-3:-1]
    cpu_map = BackwardMap(*(m.cpu() for m in bmap))
    assert not cpu_map.covered.all()
    want = render_cuda.warp_plain(frame.cpu(), cpu_map, border)
    assert torch.equal(warped.cpu(), want), case
    assert torch.equal(cropped.cpu(), render_cuda.crop_resize_plain(want, crop.cpu(), h, w)), case


@pytest.mark.cuda
def test_kernels_capture_and_replay_in_a_cuda_graph_on_card():
    dev = _card()
    frames, bmap = _block(dev, 8, 360, 640, 3, seed=1)
    other, other_map = _block(dev, 8, 360, 640, 3, seed=2)
    crop = stabilize.block_crop(bmap, 360, 640)
    other_crop = stabilize.block_crop(other_map, 360, 640)
    border = stabilize.border_color(CONFIG, 3)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # the warm-up a capture needs
        render_cuda.crop_resize(render_cuda.warp(frames, bmap, border), crop, 360, 640)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = render_cuda.crop_resize(render_cuda.warp(frames, bmap, border), crop, 360, 640)
    for src, src_map, src_crop in ((other, other_map, other_crop), (frames, bmap, crop)):
        want = render_cuda.crop_resize_plain(
            render_cuda.warp_plain(src.cpu(), BackwardMap(*(m.cpu() for m in src_map)), border),
            src_crop.cpu(), 360, 640)
        frames.copy_(src)
        for m, s in zip(bmap, src_map):
            m.copy_(s)
        crop.copy_(src_crop)
        graph.replay()
        assert torch.equal(out.cpu(), want)


@pytest.mark.cuda
def test_each_entry_point_launches_once_a_block_on_card():
    dev = _card()
    config = MeshFlowConfig()
    unstab = grid.vertex_grid(config, 360, 640, device=dev)
    rng = np.random.default_rng(4)
    disp = torch.from_numpy(rng.normal(0, 2, (16,) + tuple(unstab.shape)).astype(F32)).to(dev)
    frames = torch.from_numpy(rng.integers(0, 256, (16, 360, 640, 3), dtype=np.uint8)).to(dev)
    track = frames[..., :1].contiguous()
    before = (bmap_cuda.backward_map.launches, render_cuda.warp.launches,
              render_cuda.crop_resize.launches)
    bmap, stab, stab_track = stabilize.render_block(frames, track, torch.zeros_like(disp), disp,
                                                    unstab, config, 360, 640)
    crop = stabilize.block_crop(bmap, 360, 640)
    stabilize.crop_frames(stab, crop, 360, 640)
    stabilize.crop_frames(stab_track, crop, 360, 640)
    after = (bmap_cuda.backward_map.launches, render_cuda.warp.launches,
             render_cuda.crop_resize.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 2, 2]


@pytest.mark.cuda
def test_render_syncs_nothing_on_card():
    dev = _card()
    config = MeshFlowConfig()
    unstab = grid.vertex_grid(config, 360, 640, device=dev)
    rng = np.random.default_rng(5)
    disp = torch.from_numpy(rng.normal(0, 2, (16,) + tuple(unstab.shape)).astype(F32)).to(dev)
    frames = torch.from_numpy(rng.integers(0, 256, (16, 360, 640, 3), dtype=np.uint8)).to(dev)
    zeros = torch.zeros_like(disp)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stab, crop = stabilize.render_stabilized(frames, zeros, disp, unstab, config, 360, 640)
        stabilize.crop_frames(stab, crop, 360, 640)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
