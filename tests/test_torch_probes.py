"""PyTorch port: the probes' plain versions (``meshflow_tpu_torch.probes``)
against the TPU probe kernels of ``scripts/probe_*.py``, run in Pallas
interpret mode on the CPU, on the same numpy inputs made from a seed.

Every comparison is exact equality, including slices whose starts leave
the plane (interpret mode clamps a start into [0, dim - size] after
wrapping a negative one once), except the fine row select of probe D with
a random selection matrix: the CPU's dot product sums in another order
than the port's row-by-row sum, so that case is held to 1e-6 relative.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import meshflow_tpu  # noqa: F401  (precision pins, before the probe scripts)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import probe_aligned_dynslice as jax_e  # noqa: E402
import probe_dynslice_fetch as jax_d  # noqa: E402
import probe_scalar_from_vmem as jax_g  # noqa: E402
import probe_select_rows as jax_f  # noqa: E402

from meshflow_tpu_torch.probes import (  # noqa: E402
    aligned_dynslice,
    dynslice_fetch,
    scalar_from_vmem,
    select_rows,
)
from meshflow_tpu_torch.probes._slices import dyn_start  # noqa: E402

SMEM, VMEM = pltpu.SMEM, pltpu.VMEM
B, REPS = 4, 3
# row and column starts of probe D: aligned, unaligned, past the plane
# (the probe's own inputs reach (296, 512); (320, 640) is clamped to
# (280, 408)), and negative (wrapped by the plane's size, then clamped)
D_IDX = np.array([0, 0, 37, 130, 320, 640, -16, -100], np.int32)


def _interpret(kernel, out_shape, scratch, *args, smem_first=True):
    specs = [pl.BlockSpec(memory_space=SMEM if smem_first and i == 0 else VMEM)
             for i in range(len(args))]
    outs = out_shape if isinstance(out_shape, tuple) else (out_shape,)
    fn = pl.pallas_call(
        kernel, grid=(), in_specs=specs,
        out_specs=tuple(pl.BlockSpec(memory_space=VMEM) for _ in outs),
        out_shape=outs, scratch_shapes=scratch, interpret=True,
    )
    return [np.asarray(o) for o in fn(*(jnp.asarray(a) for a in args))]


def _d_plane(seed=0):
    return np.random.default_rng(seed).random((jax_d.HPAD, jax_d.WPAD), np.float32)


def _f32(shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def test_dyn_start_wraps_once_then_clamps():
    assert [dyn_start(s, 64, 16) for s in (0, 17, 48, 56, 200, -8, -60, -100)] == [
        0, 17, 48, 48, 48, 48, 4, 0
    ]
    starts = torch.tensor([0, 17, 48, 56, 200, -8, -60, -100])
    assert dyn_start(starts, 64, 16).tolist() == [0, 17, 48, 48, 48, 48, 4, 0]


def test_d_probe_inputs_are_the_scripts():
    idx, plane = dynslice_fetch.probe_inputs(16)
    rng = np.random.default_rng(0)
    want = np.zeros(32, np.int32)
    want[0::2] = rng.integers(0, (jax_d.HPAD - jax_d.BAND_R) // 8, 16) * 8
    want[1::2] = rng.integers(0, (jax_d.WPAD - jax_d.BAND_C) // 128 + 1, 16) * 128
    np.testing.assert_array_equal(idx.numpy(), want)
    np.testing.assert_array_equal(plane.numpy(), rng.random((jax_d.HPAD, jax_d.WPAD), np.float32))
    assert (dynslice_fetch.PN, dynslice_fetch.REPS) == (jax_d.PN, jax_d.REPS)


def test_d_copy_matches_pallas():
    plane = _d_plane()

    def kernel(idx_ref, plane_ref, out_ref, bands_ref, band_s):
        jax_d.copy_kernel(idx_ref, plane_ref, out_ref, band_s, b=B, reps=REPS)
        bands_ref[...] = band_s[...]

    out, bands = _interpret(
        kernel, (_f32((8, 128)), _f32((B, jax_d.BAND_R, jax_d.BAND_C))),
        [VMEM((B, jax_d.BAND_R, jax_d.BAND_C), jnp.float32)], D_IDX, plane,
    )
    got_out, got_bands = dynslice_fetch.dynslice_copy(
        torch.from_numpy(D_IDX), torch.from_numpy(plane), reps=REPS
    )
    np.testing.assert_array_equal(got_out.numpy(), out)
    np.testing.assert_array_equal(got_bands.numpy(), bands)
    assert dynslice_fetch.dynslice_copy.launches == 0


@pytest.mark.parametrize("selection", ["one-hot", "random"])
def test_d_fine_matches_pallas(selection):
    """The probe's fine_kernel reads rsel_s, which nothing writes; here a
    wrapper kernel fills it from an input first."""
    plane = _d_plane(1)
    if selection == "one-hot":
        rsel = dynslice_fetch.one_hot_rsel(B, seed=3).numpy()
    else:
        rsel = np.random.default_rng(3).random((B, jax_d.PN, jax_d.BAND_R), np.float32)

    def kernel(idx_ref, plane_ref, rsel_ref, out_ref, bands_ref, band_s, rsel_s):
        rsel_s[...] = rsel_ref[...]
        jax_d.fine_kernel(idx_ref, plane_ref, out_ref, band_s, rsel_s, b=B, reps=REPS)
        bands_ref[...] = band_s[...]

    out, bands = _interpret(
        kernel, (_f32((8, 128)), _f32((B, jax_d.BAND_R, jax_d.BAND_C))),
        [VMEM((B, jax_d.BAND_R, jax_d.BAND_C), jnp.float32),
         VMEM((B, jax_d.PN, jax_d.BAND_R), jnp.float32)],
        D_IDX, plane, rsel,
    )
    got_out, got_bands, rows = dynslice_fetch.dynslice_fine(
        torch.from_numpy(D_IDX), torch.from_numpy(plane), torch.from_numpy(rsel), reps=REPS
    )
    np.testing.assert_array_equal(got_bands.numpy(), bands)
    assert torch.equal(got_out, rows[-1, :8, :128])
    if selection == "one-hot":
        np.testing.assert_array_equal(got_out.numpy(), out)
        offsets = rsel.argmax(-1)[:, 0]
        for i, o in enumerate(offsets):
            assert torch.equal(rows[i], got_bands[i, o : o + jax_d.PN])
    else:
        np.testing.assert_allclose(got_out.numpy(), out, rtol=1e-6, atol=0)


@pytest.mark.parametrize("first_row", [0, 300, -5])
def test_d_onehot_matches_pallas(first_row):
    """idx[0] = 300: rows 300 + r % 4 + k % 40 run past the plane's 328
    rows, and idx[0] = -5: the first rows lie before the plane; the
    one-hot select gives zeros for both."""
    plane = _d_plane(2)
    idx = D_IDX.copy()
    idx[0] = first_row

    def kernel(idx_ref, plane_ref, out_ref):
        jax_d.onehot_kernel(idx_ref, plane_ref, out_ref, b=B, reps=REPS)

    (out,) = _interpret(kernel, _f32((8, 128)), [], idx, plane)
    got_out, band = dynslice_fetch.onehot_rowsel(
        torch.from_numpy(idx), torch.from_numpy(plane), reps=REPS
    )
    np.testing.assert_array_equal(got_out.numpy(), out)
    assert band.shape == (B * jax_d.PN, jax_d.WPAD)
    t = first_row + (REPS - 1) % 4 + np.arange(B * jax_d.PN) % jax_d.PN
    inside = (t >= 0) & (t < jax_d.HPAD)
    want = np.where(inside[:, None], plane[np.clip(t, 0, jax_d.HPAD - 1)], 0.0)
    np.testing.assert_array_equal(band.numpy(), want)


def test_e_matches_pallas():
    plane, r0 = aligned_dynslice.probe_inputs()
    np.testing.assert_array_equal(
        plane.numpy(), np.arange(jax_e.H * jax_e.W, dtype=np.float32).reshape(jax_e.H, jax_e.W)
    )
    assert r0.tolist() == [37]
    for row in (0, 7, 37, 233, 239, 240, 250, 255):
        (want,) = _interpret(
            jax_e.kernel, _f32((jax_e.ROWS, jax_e.W)), [],
            np.array([row], np.int32), plane.numpy(),
        )
        got = aligned_dynslice.aligned_rows(plane, torch.tensor([row], dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"r0={row}")
        if row <= 239:
            np.testing.assert_array_equal(got.numpy(), plane.numpy()[row : row + 16])
    assert aligned_dynslice.aligned_rows.launches == 0


@pytest.mark.parametrize("nrows", [48, 144])
def test_f_matches_pallas(monkeypatch, nrows):
    """The probe's kernel is nested in run_case; it runs unchanged with a
    `pl` whose pallas_call adds interpret=True and keeps what it saw."""
    seen = {}

    def pallas_call(kernel, **kwargs):
        call = pl.pallas_call(kernel, interpret=True, **kwargs)

        def run(*args):
            seen["args"], seen["out"] = args, call(*args)
            return seen["out"]

        return run

    monkeypatch.setattr(jax_f, "pl", types.SimpleNamespace(pallas_call=pallas_call,
                                                           BlockSpec=pl.BlockSpec))
    assert jax_f.run_case(nrows, bp=512)
    table, cells = select_rows.probe_inputs(nrows, bp=512)
    np.testing.assert_array_equal(table.numpy(), np.asarray(seen["args"][0]))
    np.testing.assert_array_equal(cells.numpy(), np.asarray(seen["args"][1]))
    got = select_rows.select_rows(table, cells)
    np.testing.assert_array_equal(got.numpy(), np.asarray(seen["out"]))
    exact, bad, size, rel = select_rows.select_report(got, select_rows.select_rows_plain(table, cells))
    assert (exact, bad, size, rel) == (True, 0, nrows * 512, 0.0)
    assert select_rows.select_rows.launches == 0


def test_g_matches_pallas():
    plane, corners = scalar_from_vmem.probe_inputs()
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(plane.numpy(), rng.random((jax_g.H, jax_g.W), np.float32))
    np.testing.assert_array_equal(
        corners.numpy()[:, 0], rng.integers(0, (jax_g.H - jax_g.ROWS) // 2, jax_g.B)
    )
    # bases 0, 8, 40, 48, 48, 56 (clamped to 48), -8 (wrapped to 56, clamped to 48), 16
    values = [0.0, 3.7, 20.0, 24.0, 27.0, 31.4, -1.2, 10.0]
    corners = scalar_from_vmem.corners_from(values)
    (want,) = _interpret(
        jax_g.kernel, _f32((jax_g.B, 1, jax_g.W)), [VMEM((jax_g.B, 128), jnp.float32)],
        plane.numpy(), corners.numpy(), smem_first=False,
    )
    got = scalar_from_vmem.band_row(plane, corners)
    np.testing.assert_array_equal(got.numpy(), want)
    rows = [0, 8, 40, 48, 48, 48, 48, 16]
    np.testing.assert_array_equal(got.numpy()[:, 0], plane.numpy()[rows])
    assert scalar_from_vmem.band_row.launches == 0


def test_probes_import_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['meshflow_tpu'] = None\n"
        "import meshflow_tpu_torch.probes\n"
        "from meshflow_tpu_torch.probes import __main__ as entry\n"
        "assert entry.PROBES == ('dynslice_fetch', 'aligned_dynslice', 'select_rows', "
        "'scalar_from_vmem')\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'meshflow_tpu.')) "
        "for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_entry_point_runs_plain_versions_on_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "meshflow_tpu_torch.probes", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    for line in ("aligned-dynamic-slice OK", "scalar handoff OK",
                 "rows=  48: exact=True", "rows= 432: exact=True",
                 "dynslice+fine-rowsel (B=128)", "full-plane one-hot rowsel (B=16)"):
        assert line in out, out
    assert " us" not in out  # no time off the card
