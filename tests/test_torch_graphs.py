"""PyTorch port: the graphed units and their runner (``utils/graphs.py``)
on the CPU.

* The motion and metric batches padded to PAIR_BATCH give the real rows
  of the unpadded batch exactly (a ragged tail of 11 pairs of 16): every
  op of a batch works row by row.  The padded route is the one every
  device takes, so ``test_torch_slice.py`` and
  ``test_torch_motion_solver.py`` hold it against JAX within their gates.
* The runner, through a stand-in whose capture runs the function once on
  its static inputs and whose replay reruns it there, writing into the
  same static outputs, as a CUDA graph's replay does: a key's first call
  runs eagerly and its second captures, a later call does not overwrite
  a result already returned, and each replay adds its recorded launches
  to the wrappers' counters once.
* The online step with its step count as a tensor, replayed through the
  stand-in, against the JAX package's ``online_step`` across the
  window-fill boundary (frames 1 to 2 omega + 2, omega = 3, the sizes of
  ``test_torch_online.py`` and its tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import meshflow_tpu  # noqa: F401  (precision pins)
from meshflow_tpu import online as jonline
from meshflow_tpu.config import MeshFlowConfig as JaxConfig

from meshflow_tpu_torch import online
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.kernels import _launch
from meshflow_tpu_torch.metrics import quality
from meshflow_tpu_torch.motion import pipeline as tpipe
from meshflow_tpu_torch.utils import graphs, grid, prng
from test_torch_online import FIELDS, _check_step, _clip as _online_clip
from test_torch_slice import TINY, _clip
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)


class _StandInGraph:
    """A CPU stand-in for a captured graph: replay reruns the function on
    the static inputs and writes the static outputs in place."""

    def __init__(self, fn, args, static, outputs):
        self.fn, self.args, self.static, self.outputs = fn, args, static, outputs

    def replay(self):
        with _launch.recording():  # a replay's launches come from the record
            new = self.fn(*self.args, *self.static)
        for dst, src in zip(torch.utils._pytree.tree_leaves(self.outputs),
                            torch.utils._pytree.tree_leaves(new)):
            dst.copy_(src)


class StandInRunner(graphs.GraphRunner):
    """GraphRunner that 'captures' on the CPU."""

    def graphs_on(self, device):
        return self.enabled

    def _warm_up(self, fn, args, static, device):
        return fn(*args, *static)

    def _record(self, fn, args, static, device):
        outputs = fn(*args, *static)
        return _StandInGraph(fn, args, static, outputs), outputs

    def _replay(self, graph, device):
        graph.replay()


@pytest.fixture(scope="module")
def tail_block():
    """The tracks of an 11-pair block (TINY config, 12 frames of 180x320)."""
    h, w = 180, 320
    config = MeshFlowConfig(**TINY)
    frames = torch.from_numpy(_clip(12, h, w, pan=12))
    kps, _ = tpipe.prepare_frames(frames, config)
    late, tracked = tpipe.track_pairs(kps, frames, config, h, w)
    keys = prng.fold_in(prng.PRNGKey(0), torch.arange(tpipe.PAIR_BATCH))
    return config, h, w, kps, late, tracked, keys


def _padded(t):
    return tpipe.pad_rows(t, tpipe.PAIR_BATCH)


def test_padded_motion_batch_keeps_the_real_rows(tail_block):
    config, h, w, kps, late, tracked, keys = tail_block
    real = late.shape[0]
    assert real == 11
    vgrid = grid.vertex_grid(config, h, w)
    want = tpipe.motion_batch(kps.positions[:real], late, tracked, keys[:real], vgrid,
                              config, h, w)
    got = tpipe.motion_batch(_padded(kps.positions[:real]), _padded(late), _padded(tracked),
                             keys, vgrid, config, h, w)
    for a, b in zip(want, got):
        assert b.shape[0] == tpipe.PAIR_BATCH
        assert torch.equal(a, b[:real])
    assert not got[2][real:].any()  # the padding pairs match nothing
    # pair_velocities pads its last batch: the same rows again
    frames = torch.from_numpy(_clip(12, h, w, pan=12))
    vel, homo, ok = tpipe.pair_velocities(kps, frames, prng.PRNGKey(0), 0, config, h, w)
    assert torch.equal(vel, want[0]) and torch.equal(homo, want[1])
    assert torch.equal(ok, want[2])


def test_padded_metric_batch_keeps_the_real_rows(tail_block):
    config, h, w, kps, late, tracked, keys = tail_block
    real = late.shape[0]
    want = quality.metric_batch(kps.positions[:real], late, tracked, keys[:real], config)
    got = quality.metric_batch(_padded(kps.positions[:real]), _padded(late),
                               _padded(tracked), keys, config)
    for a, b in zip(want, got):
        assert torch.equal(a, b[:real])
        assert (b[real:] == 1.0).all()  # unmatched frames score 1


def _affine(x, scale):
    """A stand-in unit: two kernel launches recorded, outputs made anew."""
    _launch.count(_affine)
    _launch.count(_affine)
    return x * scale + 1.0, (x.sum(0), x.amax(0))


_affine.launches = 0


def test_runner_results_survive_later_calls():
    runner = StandInRunner()
    a = torch.arange(12.0).reshape(4, 3)
    b = -torch.arange(12.0).reshape(4, 3)
    first = runner.run(_affine, (a,), 2.0)  # the warm-up run's outputs
    assert runner.captures == 0 and runner.replays == 0
    second = runner.run(_affine, (b,), 2.0)  # captured, then replayed
    third = runner.run(_affine, (a + 1,), 2.0)  # a replay over the same buffers
    for got, x in ((first, a), (second, b), (third, a + 1)):
        want = _affine(x, 2.0)
        assert torch.equal(got[0], want[0])
        assert all(torch.equal(g, v) for g, v in zip(got[1], want[1]))
    assert runner.captures == 1 and runner.replays == 2
    for _ in range(2):
        runner.run(_affine, (a[:2],), 2.0)  # another shape: another graph
        runner.run(_affine, (a,), 3.0)  # another static argument: another graph
    assert runner.captures == 3 and runner.replays == 4
    runner.clear()
    runner.run(_affine, (a,), 2.0)  # cleared: warmed up again
    assert runner.captures == 3
    runner.run(_affine, (a,), 2.0)  # and captured again
    assert runner.captures == 4 and runner.replays == 5


def test_runner_adds_each_replays_launches_once():
    runner = StandInRunner()
    x = torch.ones(3)
    start = _affine.launches
    runner.run(_affine, (x,), 1.0)  # the warm-up counted
    assert _affine.launches - start == 2
    for n in range(1, 4):
        runner.run(_affine, (x,), 1.0)  # the first captures (recorded), each replays
        assert _affine.launches - start == 2 + 2 * n
    with _launch.recording() as rec:  # a capture inside a capture's record
        runner.run(_affine, (x,), 1.0)
    assert rec[_affine] == 0 and _affine.launches - start == 10


def test_runner_calls_directly_off_the_card():
    calls = []

    def unit(x, k):
        calls.append(k)
        return (x + k,)

    for runner in (graphs.GraphRunner(), graphs.GraphRunner(enabled=False)):
        for _ in range(2):
            out = runner.run(unit, (torch.zeros(2),), 5)
            assert torch.equal(out[0], torch.full((2,), 5.0)) and runner.captures == 0
    assert torch.equal(graphs.run(None, unit, (torch.zeros(2),), 5)[0], torch.full((2,), 5.0))
    assert calls == [5] * 5


OMEGA = 3


@pytest.fixture(scope="module")
def jax_window_run():
    """JAX online mode over frames 0..2 omega + 2: c_t, p_t and the output
    of each step."""
    frames = _online_clip(np.random.default_rng(4321), 2 * OMEGA + 3)
    h, w = frames[0].shape[:2]
    config = JaxConfig(**FIELDS, temporal_smoothing_radius=OMEGA)
    key = jax.random.PRNGKey(0)
    zeros = jnp.zeros((OMEGA + 1, config.vertex_rows, config.vertex_cols, 2), jnp.float32)
    kps0, pyr0 = jonline.online_prepare(jnp.asarray(frames[0]), config, h, w)
    state = jonline.OnlineState(pyr0, kps0, zeros, zeros, jnp.asarray(0, jnp.int32))
    steps = []
    for frame in frames[1:]:
        state, out = jonline.online_step(state, jnp.asarray(frame), key, config, h, w)
        steps.append((None, np.asarray(state.unstab_window[-1]),
                      np.asarray(state.stab_window[-1]), np.asarray(out)))
    return frames, steps


def test_online_step_graphed_matches_jax_across_the_window_fill(jax_window_run):
    frames, steps = jax_window_run
    h, w = frames[0].shape[:2]
    config = MeshFlowConfig(**FIELDS, temporal_smoothing_radius=OMEGA)
    key = prng.PRNGKey(0)
    state = online.initial_state(torch.from_numpy(frames[0]), config)
    assert state.step.dtype == torch.int64 and state.step.dim() == 0
    consts = online.online_constants(config, h, w, 0.8, "cpu")
    runner = StandInRunner()
    for t, frame in enumerate(frames[1:]):
        state, out = online.online_step(state, torch.from_numpy(frame), key, config, h, w,
                                        consts=consts, runner=runner)
        assert int(state.step) == t + 1
        _check_step(t, state.unstab_window[-1], state.stab_window[-1], out, steps[t])
    assert runner.captures == 1 and runner.replays == len(frames) - 2
