"""PyTorch port: the gray-plane route (track_planes="gray") against the JAX
package's gray route on the CPU.

The JAX package ships cv2 gray planes to the device and renders the BGR
output with its native host renderer; the port keeps the BGR frames on
the device for the render and derives the planes there.  Tolerances:

* the planes (cv2's integer gray, after the box downscale at d > 1) and
  the gray of the border colour are exact;
* a gray render has the crop of the BGR render and is within bilinear
  rounding of JAX's (PSNR >= 40 dB, tests/test_torch_render.py) and of
  the gray of the BGR render (<= 2 LSB, <= 1 on > 99% of pixels,
  tests/test_gray_mode.py:47);
* the gray slice against JAX's gray route: crop equal, metrics within
  ``test_torch_slice``'s ``_compare_slice`` gates (stability 1e-3
  relative, cropping ratio and distortion 1e-2), output <= 1 LSB on
  >= 99.5% of pixels and PSNR >= 40 dB (host against device render,
  carrying the LK endpoints' float32 round-off);
* gray streamed equals gray in-memory exactly;
* online gray against JAX's online gray (its host renderer): <= 1 LSB on
  >= 99.5% of pixels.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu import online as jonline
from meshflow_tpu.api import MeshFlowStabilizer as JaxStabilizer
from meshflow_tpu.config import MeshFlowConfig as JaxConfig
from meshflow_tpu.kernels.color import gray_of_bgr_color as jax_gray_of_bgr_color
from meshflow_tpu.motion import trackscale as jtrackscale
from meshflow_tpu.render import host as jax_host_render
from meshflow_tpu.render import stabilize as jrender
from meshflow_tpu.streaming import to_track_planes as jax_to_track_planes
from meshflow_tpu.utils import grid as jgrid

from meshflow_tpu_torch import checkpoint, online, streaming
from meshflow_tpu_torch.api import MeshFlowStabilizer
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels.color import bgr_to_gray, gray_of_bgr_color
from meshflow_tpu_torch.motion import pipeline as tpipe
from meshflow_tpu_torch.motion import trackscale
from meshflow_tpu_torch.render import stabilize as trender
from meshflow_tpu_torch.utils.profiling import StageTimer
from test_torch_online import FIELDS as ONLINE_FIELDS
from test_torch_online import _clip as online_clip
from test_torch_slice import TINY, _clip, _psnr, _rel
from test_torch_streaming import SMALL
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)

GRAY = dict(track_planes="gray")


@pytest.mark.parametrize("d", [1, 3])
def test_track_planes_gray_match_jax(d):
    """(F, th, tw, 1): at d=1 cv2's gray of the frames (JAX's host upload),
    at d=3 the gray of the box-downscaled frames, equal to JAX's device
    and host derivations; detection on them equals detection on BGR."""
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (3, 48, 66, 3), dtype=np.uint8)
    fields = dict(GRAY, track_downscale=d)
    got = trackscale.to_track_planes_dev(torch.from_numpy(frames), MeshFlowConfig(**fields))
    jc = JaxConfig(**fields)
    assert got.shape == (3, 48 // d, 66 // d, 1) and got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jtrackscale.to_track_planes_dev(jnp.asarray(frames), jc)))
    host = jax_to_track_planes(jtrackscale.box_downscale_host(frames, d), jc)
    np.testing.assert_array_equal(got.numpy(), host)
    bgr = trackscale.to_track_planes_dev(torch.from_numpy(frames),
                                         MeshFlowConfig(track_downscale=d))
    for a, b in zip(tpipe.prepare_frames(got, MeshFlowConfig())[0],
                    tpipe.prepare_frames(bgr, MeshFlowConfig())[0]):
        assert torch.equal(a, b)


def test_border_gray_matches_jax_and_cv2():
    for color in [(0, 0, 255), (17, 200, 3), (255, 255, 255), (0, 0, 0)]:
        px = np.array([[color]], np.uint8)
        want = int(cv2.cvtColor(px, cv2.COLOR_BGR2GRAY)[0, 0])
        assert gray_of_bgr_color(color) == jax_gray_of_bgr_color(color) == want
        assert trender.border_color(MeshFlowConfig(color_outside_image_area_bgr=color), 1) == [want]


def test_gray_render_matches_jax_and_commutes_with_gray(rng):
    """render_stabilized on (F, H, W, 1) planes: JAX's crop and bytes within
    the render gate, and the gray of the BGR render within bilinear
    rounding, with the BGR render's crop."""
    config = MeshFlowConfig(mesh_row_count=4, mesh_col_count=4)
    jc = JaxConfig(mesh_row_count=4, mesh_col_count=4)
    f, h, w = 3, 48, 64
    base = rng.integers(0, 256, (f, h // 4 + 1, w // 4 + 1, 3)).astype(np.float32)
    frames = np.repeat(np.repeat(base, 4, 1), 4, 2)[:, :h, :w]
    for ax in (1, 2):
        frames = 0.25 * np.roll(frames, 1, ax) + 0.5 * frames + 0.25 * np.roll(frames, -1, ax)
    frames = np.round(frames).astype(np.uint8)
    vr, vc = config.vertex_rows, config.vertex_cols
    du = rng.normal(0, 1.0, (f, vr, vc, 2)).astype(np.float32)
    ds = rng.normal(0, 1.0, (f, vr, vc, 2)).astype(np.float32)
    unstab = np.asarray(jgrid.vertex_grid(jc, h, w), np.float32)
    gray = bgr_to_gray(torch.from_numpy(frames))[..., None]
    args = (torch.from_numpy(du), torch.from_numpy(ds), torch.from_numpy(unstab), config, h, w)
    stab_gray, crop_gray = trender.render_stabilized(gray, *args)
    stab_bgr, crop_bgr = trender.render_stabilized(torch.from_numpy(frames), *args)
    jstab, jcrop = jrender.render_stabilized(
        jnp.asarray(gray.numpy()), jnp.asarray(du), jnp.asarray(ds), jnp.asarray(unstab),
        jc, h, w)
    assert stab_gray.shape == (f, h, w, 1)
    assert crop_gray.tolist() == crop_bgr.tolist() == np.asarray(jcrop).tolist()
    assert _psnr(stab_gray.numpy(), np.asarray(jstab)) >= 40.0
    diff = (bgr_to_gray(stab_bgr).to(torch.int16) - stab_gray[..., 0].to(torch.int16)).abs()
    assert diff.max() <= 2
    assert (diff <= 1).float().mean() > 0.99


def test_gray_slice_matches_jax_gray_route(monkeypatch):
    """The gray slice (TINY config, CHUNK 4, 10 frames of 180x320) against
    JAX's gray route: cv2 gray planes uploaded, the BGR frames on the host,
    the native host renderer, the default device metric source."""
    if not jax_host_render.available():
        pytest.skip("the JAX package's native host renderer does not load here")
    monkeypatch.setenv("MESHFLOW_RENDER", "host")
    for cls in (JaxStabilizer, MeshFlowStabilizer):
        monkeypatch.setattr(cls, "CHUNK", 4)
    num_frames, h, w = 10, 180, 320
    frames = _clip(num_frames, h, w, pan=12)
    jc = JaxConfig(**TINY, **GRAY)
    js = JaxStabilizer(config=jc)
    crops = []
    render = jax_host_render.render_stabilized_host

    def render_and_keep_crop(*args):
        out = render(*args)
        crops.append(out[1])
        return out

    monkeypatch.setattr(jax_host_render, "render_stabilized_host", render_and_keep_crop)
    js._frames_np_cache = frames
    jcropped, jratio, jdist, jstab = js._stabilize_frames(
        jnp.asarray(jax_to_track_planes(frames, jc)), 0, h, w)
    ts = MeshFlowStabilizer(config=MeshFlowConfig(**TINY, **GRAY), device="cpu")
    cropped, ratio, dist, stab = ts._stabilize_frames(torch.from_numpy(frames), 0)

    assert ts.last_crop.tolist() == [int(v) for v in crops[0]]
    assert cropped.shape == (num_frames, h, w, 3) and cropped.dtype == torch.uint8
    diff = np.abs(cropped.numpy().astype(np.int16) - np.asarray(jcropped).astype(np.int16))
    assert (diff <= 1).mean() >= 0.995, (diff <= 1).mean()
    assert _psnr(cropped.numpy(), np.asarray(jcropped)) >= 40.0
    assert _rel(stab, jstab) <= 1e-3
    assert _rel(ratio, jratio) <= 1e-2
    assert _rel(dist, jdist) <= 1e-2


def test_gray_streamed_equals_in_memory():
    """Under gray planes the stream (CHUNK 4, three pass-1 windows, metric
    blocks of 4, 4, 2) gives the in-memory route's frames and metrics."""
    frames = _clip(10, 180, 320, pan=12)
    stab = MeshFlowStabilizer(config=MeshFlowConfig(**SMALL, **GRAY), device="cpu")
    stab.CHUNK = 4
    cropped, *metrics = stab._stabilize_frames(torch.from_numpy(frames), 0)
    writer = streaming.CaptureWriter()
    got = stab._stream(streaming.ArrayClip(frames), writer, 0, StageTimer(enabled=False))
    assert torch.equal(torch.from_numpy(writer.frames()), cropped)
    assert got == tuple(float(m) for m in metrics)


def test_gray_checkpoint_key_differs(tmp_path):
    clip = tmp_path / "c.avi"
    clip.write_bytes(b"x")
    a = checkpoint.cache_path(str(tmp_path), str(clip), MeshFlowConfig(), 0, "cpu")
    b = checkpoint.cache_path(str(tmp_path), str(clip), MeshFlowConfig(**GRAY), 0, "cpu")
    assert a != b


def test_online_gray_matches_jax_online_gray():
    """OnlineMeshFlowStabilizer under gray planes, frame by frame, against
    JAX's (gray planes uploaded, BGR warped by its host renderer)."""
    if not jax_host_render.streaming_available():
        pytest.skip("the JAX package's native streaming renderer does not load here")
    frames = online_clip(np.random.default_rng(1234), 6)
    js = jonline.OnlineMeshFlowStabilizer(config=JaxConfig(**ONLINE_FIELDS, **GRAY))
    ts = online.OnlineMeshFlowStabilizer(config=MeshFlowConfig(**ONLINE_FIELDS, **GRAY),
                                         device="cpu")
    for t, frame in enumerate(frames):
        want, got = js.process(frame), ts.process(frame)
        assert got.shape == frame.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert (diff <= 1).mean() >= 0.995, (t, (diff <= 1).mean())
