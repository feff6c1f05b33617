"""PyTorch port: the plain backward map (kernel B's twin) and the render
stage against the JAX package.

The cell homographies are homogeneous and unnormalized (entries up to
~1e8 on small cells), so evaluating them in float32 is itself ~1e-3 px
off an exact evaluation.  The JAX map reads its table through a bf16
Dekker split and the port reads float32 directly, so the two differ at
that level (measured: <= 1.1e-3 px on the 640x360 default mesh), not at
float32 round-off; hence the map gate of 2e-3 px.  Where the warp folds
(several cells' preimages of a pixel fall inside their grown bboxes), a
last-bit difference can move the fixed-point search to another candidate
window and pick another fold layer: such flips are allowed on at most 1%
of the covered pixels, coverage may flip on at most 1e-4 of the pixels
(the count is reported), and the crop edges must be equal.
Rendered bytes from equal inputs round a float32 bilinear sum that JAX
forms with a fused contraction: a byte may differ by 1 LSB on < 0.5% of
pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu.config import MeshFlowConfig as JaxConfig
from meshflow_tpu.kernels.bmap_pallas import backward_map_pallas
from meshflow_tpu.render import stabilize as jr
from meshflow_tpu.utils import grid as jgrid

from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels import bmap_cuda
from meshflow_tpu_torch.render import stabilize as tr

CASES = [
    (16, 48, 64, 1.5),   # default mesh density, mild warp
    (4, 40, 56, 6.0),    # coarse mesh, strong warp (uncovered pixels)
    (16, 48, 64, 12.0),  # heavy warp: sentinel and membership edges
    (64, 180, 320, 0.5),  # dense 64x64 mesh, 2.8x5 px cells
]


def _case(mesh, h, w, scale):
    rng = np.random.default_rng(mesh * 7 + int(scale))
    jc = JaxConfig(mesh_row_count=mesh, mesh_col_count=mesh)
    tc = MeshFlowConfig(mesh_row_count=mesh, mesh_col_count=mesh)
    unstab = np.asarray(jgrid.vertex_grid(jc, h, w), np.float32)
    stab = unstab + rng.normal(0.0, scale, unstab.shape).astype(np.float32)
    return jc, tc, stab, unstab


def _assert_close_bytes(ours, ref):
    diff = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.005


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("mesh,h,w,scale", CASES)
def test_plain_backward_map_matches_jax(mesh, h, w, scale, oracle):
    jc, tc, stab, unstab = _case(mesh, h, w, scale)
    if oracle == "xla":
        ref = jr.backward_map(jnp.asarray(stab), jnp.asarray(unstab), jc, h, w)
    else:
        ref = backward_map_pallas(jnp.asarray(stab), jnp.asarray(unstab), jc, h, w, interpret=True)
    ours = bmap_cuda.backward_map(torch.from_numpy(stab), torch.from_numpy(unstab), tc, h, w)
    assert bmap_cuda.backward_map.launches == 0  # CPU tensors: plain version
    ref_cov = np.asarray(ref.covered)
    cov = ours.covered.numpy()
    mismatch = int((cov != ref_cov).sum())
    assert mismatch <= 1e-4 * h * w, f"{mismatch} coverage mismatches"
    both = cov & ref_cov
    err = np.maximum(
        np.abs(ours.map_x.numpy() - np.asarray(ref.map_x)),
        np.abs(ours.map_y.numpy() - np.asarray(ref.map_y)),
    )[both]
    assert (err > 2e-3).mean() <= 0.01, f"{int((err > 2e-3).sum())} fold flips"
    np.testing.assert_array_equal(
        tr.crop_edges(ours, h, w).numpy(), np.asarray(jr.crop_edges(ref, h, w))
    )
    if mesh == 4:
        assert (~cov).any()  # the sentinel path was exercised


@pytest.mark.parametrize("border", [None, (0, 0, 255)])
def test_bilinear_sample_and_warp_match(rng, border):
    h, w = 40, 56
    frame = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    sx = rng.uniform(-3, w + 2, 500).astype(np.float32)
    sy = rng.uniform(-3, h + 2, 500).astype(np.float32)
    ours = tr.bilinear_sample(torch.from_numpy(frame), torch.from_numpy(sx), torch.from_numpy(sy), border)
    ref = jr.bilinear_sample(jnp.asarray(frame), jnp.asarray(sx), jnp.asarray(sy), border)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-3)
    if border is None:
        return
    jc, tc, stab, unstab = _case(16, h, w, 6.0)
    ref_map = jr.backward_map(jnp.asarray(stab), jnp.asarray(unstab), jc, h, w)
    our_map = tr.BackwardMap(*(torch.from_numpy(np.array(m)) for m in ref_map))
    _assert_close_bytes(
        tr.warp_frame(torch.from_numpy(frame), our_map, border).numpy(),
        np.asarray(jr.warp_frame(jnp.asarray(frame), ref_map, jnp.asarray(border, jnp.float32))),
    )


@pytest.mark.parametrize("crop", [(0, 0, 159, 89), (3, 2, 150, 86), (11, 4, 143, 83)])
def test_crop_resize_frame_matches(rng, crop):
    h, w = 90, 160
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    ours = tr.crop_frames(torch.from_numpy(frames), torch.tensor(crop), h, w).numpy()
    ref = np.asarray(jr.crop_frames(jnp.asarray(frames), jnp.asarray(crop, jnp.int32), h, w))
    _assert_close_bytes(ours, ref)


def test_render_stabilized_matches(rng):
    """Whole render of smooth frames through an unfolded warp: equal crop,
    and frames within the map gate's effect on bytes (PSNR >= 40 dB)."""
    h, w, f = 90, 160, 3
    jc, tc, _, unstab = _case(8, h, w, 1.0)
    base = rng.integers(0, 256, (f, h // 6 + 1, w // 6 + 1, 3)).astype(np.float32)
    frames = np.repeat(np.repeat(base, 6, 1), 6, 2)[:, :h, :w]
    for _ in range(3):
        for ax in (1, 2):
            frames = 0.25 * np.roll(frames, 1, ax) + 0.5 * frames + 0.25 * np.roll(frames, -1, ax)
    frames = np.round(frames).astype(np.uint8)
    du = rng.normal(0, 2.0, (f,) + unstab.shape).astype(np.float32)
    ds = du + rng.normal(0, 1.0, (f,) + unstab.shape).astype(np.float32)
    ours, crop = tr.render_stabilized(
        torch.from_numpy(frames), torch.from_numpy(du), torch.from_numpy(ds),
        torch.from_numpy(unstab), tc, h, w,
    )
    ref, ref_crop = jr.render_stabilized(
        jnp.asarray(frames), jnp.asarray(du), jnp.asarray(ds), jnp.asarray(unstab), jc, h, w
    )
    np.testing.assert_array_equal(crop.numpy(), np.asarray(ref_crop))
    mse = np.mean((ours.numpy().astype(np.float64) - np.asarray(ref).astype(np.float64)) ** 2)
    assert mse == 0 or 10 * np.log10(255.0**2 / mse) >= 40.0
