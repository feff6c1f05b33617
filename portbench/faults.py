"""Faults planted in the program's timed path, to show that ``correct``
catches them: on the CPU in ``tests/test_portbench_faults.py``, and on the
card by ``control.py --faults`` (readings that set the upper end of the
numbers the control does not move)."""

from __future__ import annotations

import contextlib


def _altered(out):
    out = out.clone()
    region = out[len(out) // 2] if out.dim() == 4 else out
    region[:32, :32] ^= 0x10
    return out


def _answer_altered(fn):
    """One output frame of a block has a 32x32 corner's bits flipped."""
    return lambda *args, **kwargs: _altered(fn(*args, **kwargs))


def _state_unchanged_solver(fn):
    """The path solver returns its input path unchanged."""
    return lambda displacements, *args, **kwargs: displacements


def _motion_half_batch(fn):
    """A motion batch leaves out its second half: those pairs move nothing."""
    def wrapped(*args, **kwargs):
        velocities, homographies, ok = fn(*args, **kwargs)
        velocities = velocities.clone()
        velocities[len(velocities) // 2:] = 0
        return velocities, homographies, ok
    return wrapped


def _metric_half_batch(fn):
    """A metric batch scores its first half only: the second half repeats
    the first half's scores, so the clip's mean and minimum come from the
    rest."""
    def wrapped(*args, **kwargs):
        ratios, distortions = (t.clone() for t in fn(*args, **kwargs))
        half = len(ratios) // 2
        ratios[half:2 * half] = ratios[:half]
        distortions[half:2 * half] = distortions[:half]
        return ratios, distortions
    return wrapped


def _step_state_unchanged(fn):
    """The online step returns the state it was given."""
    def wrapped(prev_planes, prev_kps, unstab_window, stab_window, step, *args):
        *_, out = fn(prev_planes, prev_kps, unstab_window, stab_window, step, *args)
        return prev_planes, prev_kps, unstab_window, stab_window, step, out
    return wrapped


# name: (module, attribute, wrapper, loop it applies to)
FAULTS = {
    "answer-altered": ("meshflow_tpu_torch.api", "crop_frames", _answer_altered, "closed"),
    "solver-state-unchanged": ("meshflow_tpu_torch.api", "jacobi_smooth",
                               _state_unchanged_solver, "closed"),
    "motion-half-batch": ("meshflow_tpu_torch.motion.pipeline", "motion_batch",
                          _motion_half_batch, "closed"),
    "metric-half-batch": ("meshflow_tpu_torch.metrics.quality", "metric_batch",
                          _metric_half_batch, "closed"),
    "step-state-unchanged": ("meshflow_tpu_torch.online", "_step", _step_state_unchanged, "open"),
    "online-answer-altered": ("meshflow_tpu_torch.online", "crop_resize_frame",
                              _answer_altered, "open"),
}


@contextlib.contextmanager
def planted(name: str):
    """The program with fault `name` planted while the block runs."""
    import importlib

    module_name, attr, wrap, _ = FAULTS[name]
    module = importlib.import_module(module_name)
    original = getattr(module, attr)
    setattr(module, attr, wrap(original))
    try:
        yield
    finally:
        setattr(module, attr, original)
