"""PyTorch port: online mode (``meshflow_tpu_torch/online.py``) against the
JAX package's ``online_step`` on the CPU (its XLA tracker route).

Both start from the same first frame, whose keypoints must be equal.
Tolerances: the two trackers read the same pixels but sum their windows
in another order (tests/test_torch_lk.py), and RANSAC draws are equal, so
per step the unstabilized and stabilized displacements c_t, p_t agree
within 0.05 px and the output frames at PSNR >= 40 dB.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu import online as jonline
from meshflow_tpu.config import MeshFlowConfig as JaxConfig

from meshflow_tpu_torch import interop, online
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels import bmap_cuda, lk_band_cuda, lk_cuda
from meshflow_tpu_torch.utils import prng
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)


# the configuration of tests/test_online.py::test_online_state_bootstrap
FIELDS = dict(max_features_per_subframe=32, ransac_iterations=32, lk_max_iterations=5)
STEPS = 5


def _clip(rng, num_frames, h=96, w=128, max_shift=6):
    """The jittery clip of tests/test_online.py: crops of a blurred noise
    canvas with a random walk of integer shifts."""
    canvas = rng.integers(0, 256, size=((h + 4 * max_shift) // 6, (w + 4 * max_shift) // 6),
                          dtype=np.uint8)
    canvas = cv2.resize(canvas, (w + 4 * max_shift, h + 4 * max_shift),
                        interpolation=cv2.INTER_NEAREST)
    canvas = cv2.GaussianBlur(canvas, (3, 3), 0.8)
    canvas = cv2.cvtColor(canvas, cv2.COLOR_GRAY2BGR)
    frames = []
    s = np.array([0, 0])
    for _ in range(num_frames):
        y0, x0 = 2 * max_shift + s[1], 2 * max_shift + s[0]
        frames.append(canvas[y0 : y0 + h, x0 : x0 + w].copy())
        s = np.clip(s + rng.integers(-2, 3, size=2), -max_shift, max_shift)
    return frames


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0**2 / mse)


@pytest.fixture(scope="module")
def jax_run():
    """JAX online mode over the clip: per step (state before, c_t, p_t,
    output frame)."""
    frames = _clip(np.random.default_rng(1234), STEPS + 1)
    h, w = frames[0].shape[:2]
    config = JaxConfig(**FIELDS)
    key = jax.random.PRNGKey(0)
    omega = config.temporal_smoothing_radius
    zeros = jnp.zeros((omega + 1, config.vertex_rows, config.vertex_cols, 2), jnp.float32)
    kps0, pyr0 = jonline.online_prepare(jnp.asarray(frames[0]), config, h, w)
    state = jonline.OnlineState(pyr0, kps0, zeros, zeros, jnp.asarray(0, jnp.int32))
    steps = []
    for frame in frames[1:]:
        before = state
        state, out = jonline.online_step(state, jnp.asarray(frame), key, config, h, w)
        steps.append((before, np.asarray(state.unstab_window[-1]),
                      np.asarray(state.stab_window[-1]), np.asarray(out)))
    return frames, steps


def _check_step(step, c_t, p_t, out, want):
    _, jc, jp, jout = want
    assert np.abs(c_t.numpy() - jc).max() <= 0.05, (step, np.abs(c_t.numpy() - jc).max())
    assert np.abs(p_t.numpy() - jp).max() <= 0.05, (step, np.abs(p_t.numpy() - jp).max())
    assert out.shape == jout.shape and out.dtype == torch.uint8
    assert _psnr(out.numpy(), jout) >= 40.0, step


def test_online_step_matches_jax(jax_run):
    frames, steps = jax_run
    h, w = frames[0].shape[:2]
    config = MeshFlowConfig(**FIELDS)
    key = prng.PRNGKey(0)
    state = online.initial_state(torch.from_numpy(frames[0]), config)
    jkps = steps[0][0].prev_kps
    for a, b in zip(state.prev_kps, jkps):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    before = (lk_cuda.lk_level.launches, lk_band_cuda.lk_level_band.launches,
              bmap_cuda.backward_map.launches)
    for t, frame in enumerate(frames[1:]):
        state, out = online.online_step(state, torch.from_numpy(frame), key, config, h, w)
        assert state.step == t + 1
        _check_step(t, state.unstab_window[-1], state.stab_window[-1], out, steps[t])
    after = (lk_cuda.lk_level.launches, lk_band_cuda.lk_level_band.launches,
             bmap_cuda.backward_map.launches)
    assert after == before == (0, 0, 0)


def test_online_continues_from_jax_state(jax_run):
    frames, steps = jax_run
    h, w = frames[0].shape[:2]
    config = MeshFlowConfig(**FIELDS)
    mid = 3
    jstate = steps[mid][0]  # the JAX state after frames[mid]
    state = interop.online_state_from_numpy(
        frames[mid], *(np.asarray(a) for a in jstate.prev_kps),
        np.asarray(jstate.unstab_window), np.asarray(jstate.stab_window),
        np.asarray(jstate.step), config,
    )
    assert state.step == mid
    key = prng.PRNGKey(0)
    for t in range(mid, STEPS):
        state, out = online.online_step(state, torch.from_numpy(frames[t + 1]), key, config, h, w)
        _check_step(t, state.unstab_window[-1], state.stab_window[-1], out, steps[t])


def test_online_bootstrap_returns_first_frame():
    frames = _clip(np.random.default_rng(5), 2)
    stab = online.OnlineMeshFlowStabilizer(config=MeshFlowConfig(**FIELDS), device="cpu")
    out0 = stab.process(frames[0])
    np.testing.assert_array_equal(out0, frames[0])
    out1 = stab.process(frames[1])
    assert out1.shape == frames[1].shape and out1.dtype == np.uint8
    with pytest.raises(ValueError):
        stab.process(frames[1][:64])


@pytest.mark.parametrize("w,h,ratio", [(128, 96, 0.8), (640, 360, 0.8), (1920, 1080, 0.9),
                                       (37, 53, 0.75)])
def test_online_crop_rect_exact(w, h, ratio):
    got = online.online_crop_rect(w, h, ratio)
    want = jonline.online_crop_rect(w, h, ratio)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_online_gray_planes_raise():
    """Gray planes run (tracking on the frame's gray, the BGR frame warped:
    tests/test_torch_gray.py holds them against JAX); as in the JAX
    package, only a plane kind that does not exist raises."""
    frames = _clip(np.random.default_rng(5), 2)
    stab = online.OnlineMeshFlowStabilizer(
        config=MeshFlowConfig(**FIELDS, track_planes="gray"), device="cpu"
    )
    np.testing.assert_array_equal(stab.process(frames[0]), frames[0])
    assert stab._state.prev_planes[0].shape[2] == 1
    out = stab.process(frames[1])
    assert out.shape == frames[1].shape and out.dtype == np.uint8
    for config in (MeshFlowConfig, JaxConfig):
        with pytest.raises(ValueError, match="track_planes"):
            config(track_planes="rgb")
