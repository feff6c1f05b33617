"""PyTorch port: ``visualize`` (``MeshFlowStabilizer._display_loop``)
against the JAX package's, with ``cv2.imshow`` and ``cv2.waitKey``
stubbed: the same window name, the same stacked images in the same
order, the same delay, and a stop at Q; ``stabilize`` with
``visualize=True`` takes the in-memory route and runs the loop on the
decoded input and the written output.  Everything compared is exact.
"""

import cv2
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu.api import MeshFlowStabilizer as JaxStabilizer

from meshflow_tpu_torch.api import MeshFlowStabilizer
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.io import video as video_io
from test_torch_slice import TINY, _clip
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)


class _Display:
    """cv2.imshow / cv2.waitKey stand-ins: record every call; waitKey
    answers `keys` in turn (Q at the end)."""

    def __init__(self, monkeypatch, keys):
        self.shown, self.waits, self.keys = [], [], list(keys)
        monkeypatch.setattr(cv2, "imshow", lambda name, img: self.shown.append((name, img)))
        monkeypatch.setattr(cv2, "waitKey", self.wait_key)

    def wait_key(self, ms):
        self.waits.append(ms)
        return self.keys.pop(0)


@pytest.mark.parametrize("fps,presses", [(24.0, 5), (0.0, 2), (60.0, 7)])
def test_display_loop_matches_jax(monkeypatch, fps, presses):
    """Q after `presses` frames of a 3-frame clip: the loop wraps around
    the clip, shows input over output, waits 1000/fps ms (33 at fps 0)."""
    rng = np.random.default_rng(3)
    unstab = rng.integers(0, 256, (3, 8, 10, 3), dtype=np.uint8)
    cropped = rng.integers(0, 256, (3, 8, 10, 3), dtype=np.uint8)
    keys = [0] * (presses - 1) + [ord("q") | 0x100]  # only the low byte counts
    calls = {}
    for name, stab in (("jax", JaxStabilizer()), ("port", MeshFlowStabilizer(device="cpu"))):
        display = _Display(monkeypatch, keys)
        assert stab._display_loop(unstab, cropped, fps) is None
        calls[name] = display
    jax_calls, port_calls = calls["jax"], calls["port"]
    assert len(port_calls.shown) == presses
    assert port_calls.waits == jax_calls.waits == [int(1000 / fps) if fps > 0 else 33] * presses
    for (name, img), (jname, jimg) in zip(port_calls.shown, jax_calls.shown):
        assert name == jname == "unstabilized and stabilized video"
        np.testing.assert_array_equal(img, jimg)
    for i, (_, img) in enumerate(port_calls.shown):
        np.testing.assert_array_equal(img, np.vstack((unstab[i % 3], cropped[i % 3])))


def test_stabilize_visualize_shows_input_over_output(tmp_path, monkeypatch):
    """visualize=True: the in-memory route (MESHFLOW_STREAM=auto does not
    stream), then the loop over the decoded input and the written output."""
    frames = _clip(6, 90, 160, pan=6, seed=4)
    src, out = str(tmp_path / "in.avi"), str(tmp_path / "out.avi")
    video_io.write_video(src, frames, 24.0, cv2.VideoWriter_fourcc(*"MJPG"))
    decoded, _ = video_io.read_video(src)
    monkeypatch.setenv("MESHFLOW_STREAM", "auto")
    stab = MeshFlowStabilizer(
        config=MeshFlowConfig(**TINY, compute_metrics=False, visualize=True), device="cpu")
    shown = []
    monkeypatch.setattr(stab, "_display_loop", lambda *args: shown.append(args))
    stab.stabilize(src, out, 0)
    assert [name for name, _ in stab.last_timer.stages][:2] == ["decode", "host->device"]
    (unstab, cropped, fps), = shown
    np.testing.assert_array_equal(unstab, decoded)
    want, *_ = stab._stabilize_frames(torch.from_numpy(decoded), 0)
    np.testing.assert_array_equal(cropped, want.numpy())
    assert fps == pytest.approx(24.0)
