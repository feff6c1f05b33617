"""PyTorch port: the clip pipeline from a clip on the host (``stabilize``'s
streamed route, ``streaming.HostFrames``) against the same pipeline from a
clip on the device (``_stabilize_frames``) and against the JAX package's
streamed route.

Small shapes: the TINY config with the JAX package's reduced feature and
iteration budget for path-identity tests (``tests/test_api_e2e.py``
``test_streamed_matches_in_memory``), CHUNK 4, 10 frames of 180x320 (three
pass-1 windows, metric blocks of 4, 4 and 2).  Tolerances: the stream computes
the in-memory route's blocks with the same operations, so its frames and
metrics are equal to ``_stabilize_frames``' exactly, in every residency
mode and pipeline mode.  Against JAX's streamed route (its native host
renderer, which differs from a device render by <= 1 LSB on < 0.5 % of
pixels, ``meshflow_tpu/api.py:397-403``): the crop is equal, the frames
agree at PSNR >= 40 dB, and the metrics within ``test_torch_slice``'s
``_compare_slice`` gates (stability 1e-3 relative, cropping ratio and
distortion 1e-2 relative).
"""

import math
import threading

import cv2
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu import streaming as jax_streaming
from meshflow_tpu.api import MeshFlowStabilizer as JaxStabilizer
from meshflow_tpu.config import MeshFlowConfig as JaxConfig
from meshflow_tpu.render import host as jax_host_render

from meshflow_tpu_torch import api, streaming
from meshflow_tpu_torch.api import MeshFlowStabilizer
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.io import video as video_io
from meshflow_tpu_torch.utils.profiling import StageTimer
from test_torch_slice import TINY, _clip, _psnr, _rel
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)

CHUNK = 4
NUM_FRAMES, H, W = 10, 180, 320
SMALL = dict(TINY, max_features_per_subframe=64, ransac_iterations=64, lk_max_iterations=10,
             optimization_num_iterations=20)


def _write_mjpg(path, frames, fps=24.0):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps,
                             (frames.shape[2], frames.shape[1]))
    assert writer.isOpened()
    for f in frames:
        writer.write(f)
    writer.release()


def _stabilizer(**kwargs):
    stab = MeshFlowStabilizer(config=MeshFlowConfig(**SMALL), device="cpu", **kwargs)
    stab.CHUNK = CHUNK
    return stab


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """An MJPG clip written here, its decoded frames, and the in-memory
    route's (cropped frames, metrics) on them."""
    path = tmp_path_factory.mktemp("clip") / "in.avi"
    _write_mjpg(path, _clip(NUM_FRAMES, H, W, pan=12))
    frames, _ = video_io.read_video(str(path))
    cropped, *metrics = _stabilizer()._stabilize_frames(torch.from_numpy(frames), 0)
    return str(path), frames, cropped.numpy(), tuple(float(m) for m in metrics)


def _streamed(stab, source, variant=0):
    """``stabilize``'s streamed route from `source` into a capturing writer."""
    writer = streaming.CaptureWriter()
    metrics = stab._stream(source, writer, variant, StageTimer(enabled=False))
    return writer.frames(), metrics


@pytest.mark.parametrize("hbm_gb,cache_gb,pipeline,serving", [
    (None, None, "serial", False),
    ("0", None, "threaded", False),
    ("0", "0", "threaded", False),
    (None, None, "serial", True),
], ids=["resident", "host-cache", "redecode", "serving"])
def test_streamed_equals_in_memory(clip, monkeypatch, hbm_gb, cache_gb, pipeline, serving):
    """Frames from the device-resident prefix, from the host cache, or
    decoded again (the file read twice); serial and threaded host
    pipelines; serving mode writes the same frames and the same stability,
    with NaN for the two metric-pass scores."""
    path, frames, want_frames, want_metrics = clip
    for name, value in (("MESHFLOW_HBM_FRAME_BUDGET_GB", hbm_gb),
                        ("MESHFLOW_HOST_FRAME_CACHE_GB", cache_gb)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    monkeypatch.setenv("MESHFLOW_HOST_PIPELINE", pipeline)
    source = path if cache_gb == "0" else streaming.ArrayClip(frames)
    got_frames, got_metrics = _streamed(_stabilizer(compute_metrics=not serving), source)
    np.testing.assert_array_equal(got_frames, want_frames)
    if serving:
        assert math.isnan(got_metrics[0]) and math.isnan(got_metrics[1])
        assert got_metrics[2] == want_metrics[2]
    else:
        assert got_metrics == want_metrics


def test_threaded_pipeline_matches_serial(clip, tmp_path, monkeypatch):
    """File to file through ``stabilize``: the threaded host pipeline writes
    the serial one's bytes and returns its metrics."""
    path, *_ = clip
    monkeypatch.setenv("MESHFLOW_STREAM", "1")
    outs, metrics = [], []
    for mode in ("serial", "threaded"):
        monkeypatch.setenv("MESHFLOW_HOST_PIPELINE", mode)
        out = tmp_path / f"out-{mode}.avi"
        metrics.append(_stabilizer().stabilize(path, str(out), 0))
        outs.append(out.read_bytes())
    assert metrics[0] == metrics[1] == clip[3]
    assert outs[0] == outs[1]
    info = video_io.probe_video(str(tmp_path / "out-serial.avi"))
    assert (info.num_frames, info.height, info.width) == (NUM_FRAMES, H, W)


def test_threaded_pipeline_error_propagates(clip, tmp_path, monkeypatch):
    """An encoder error on the writer thread surfaces as the original
    exception instead of deadlocking the pipeline."""
    path, *_ = clip
    monkeypatch.setenv("MESHFLOW_STREAM", "1")
    monkeypatch.setenv("MESHFLOW_HOST_PIPELINE", "threaded")

    def boom(self, frames):
        raise IOError("synthetic encoder failure")

    monkeypatch.setattr(streaming.StreamWriter, "write", boom)
    result = {}

    def run():
        try:
            _stabilizer().stabilize(path, str(tmp_path / "out.avi"), 0)
            result["exc"] = None
        except BaseException as e:
            result["exc"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(timeout=120)
    assert not th.is_alive(), "threaded pipeline deadlocked on a writer error"
    assert isinstance(result["exc"], IOError) and "synthetic" in str(result["exc"])


def test_stream_mode_routes_like_jax(clip, tmp_path, monkeypatch):
    """MESHFLOW_STREAM: auto and 1 stream, 0 takes the in-memory route;
    1 with visualize raises JAX's RuntimeError, and auto with visualize
    takes the in-memory route and then the display loop, as JAX's does."""
    path, *_ = clip
    routes = []
    monkeypatch.setattr(MeshFlowStabilizer, "_stream",
                        lambda *a, **k: routes.append("stream") or (1.0, 1.0, 0.5))
    monkeypatch.setattr(MeshFlowStabilizer, "_stabilize_frames",
                        lambda self, frames, *a: routes.append("memory") or (
                            frames, torch.tensor(1.0), torch.tensor(1.0), torch.tensor(0.5)))
    for mode, want in (("auto", "stream"), ("1", "stream"), ("0", "memory")):
        monkeypatch.setenv("MESHFLOW_STREAM", mode)
        assert _stabilizer().stabilize(path, str(tmp_path / "out.avi"), 0) == (1.0, 1.0, 0.5)
        assert routes[-1] == want, mode
    monkeypatch.setenv("MESHFLOW_STREAM", "1")
    with pytest.raises(RuntimeError, match="MESHFLOW_STREAM=1 is incompatible with visualize"):
        JaxStabilizer(visualize=True).stabilize(path, str(tmp_path / "out.avi"), 0)
    stab = MeshFlowStabilizer(config=MeshFlowConfig(**SMALL, visualize=True), device="cpu")
    assert MeshFlowStabilizer(visualize=True, device="cpu").config.visualize
    with pytest.raises(RuntimeError, match="MESHFLOW_STREAM=1 is incompatible with visualize"):
        stab.stabilize(path, str(tmp_path / "out.avi"), 0)
    monkeypatch.setenv("MESHFLOW_STREAM", "auto")
    monkeypatch.setattr(stab, "_display_loop", lambda *a: routes.append("display"))
    assert stab.stabilize(path, str(tmp_path / "out.avi"), 0) == (1.0, 1.0, 0.5)
    assert routes == ["stream", "stream", "memory", "memory", "display"]


def test_streamed_matches_jax_streamed(clip, monkeypatch):
    """The port's stream against JAX's streamed route on this box (its
    native host renderer): crop equal, frames at PSNR >= 40 dB, metrics
    within the slice gates."""
    if not jax_host_render.streaming_available():
        pytest.skip("the JAX package's native streaming renderer does not load here")
    path, frames, *_ = clip
    monkeypatch.setenv("MESHFLOW_STREAM", "1")
    jax_out, jax_crops, port_crops = [], [], []

    class Capture:
        def __init__(self, *args):
            pass

        def write(self, batch):
            jax_out.append(np.array(batch))

        def close(self):
            pass

    crop_edges_host = jax_host_render.crop_edges_host
    monkeypatch.setattr(jax_streaming, "StreamWriter", Capture)
    monkeypatch.setattr(jax_host_render, "crop_edges_host",
                        lambda *a: jax_crops.append(crop_edges_host(*a)) or jax_crops[-1])
    intersect = api.intersect_crops
    monkeypatch.setattr(api, "intersect_crops",
                        lambda crops: port_crops.append(intersect(crops)) or port_crops[-1])
    js = JaxStabilizer(config=JaxConfig(**SMALL))
    js.CHUNK = CHUNK
    jratio, jdist, jstab = js.stabilize(path, "unused.avi", 0)
    got_frames, (ratio, dist, stab) = _streamed(_stabilizer(), streaming.ArrayClip(frames))
    assert [int(v) for v in port_crops[0].tolist()] == [int(v) for v in jax_crops[0]]
    assert _psnr(got_frames, np.concatenate(jax_out)) >= 40.0
    assert _rel(stab, jstab) <= 1e-3
    assert _rel(ratio, jratio) <= 1e-2
    assert _rel(dist, jdist) <= 1e-2
