"""Run the probes' questions: ``python -m meshflow_tpu_torch.probes``.

Usage:
    python -m meshflow_tpu_torch.probes [dynslice_fetch|aligned_dynslice|select_rows|scalar_from_vmem ...] [--device cpu]

Runs each named probe (all four by default) at its script's own sizes and
seed, on the CUDA card unless ``--device cpu`` is given, and prints the
lines its script prints: us/round and us/feature for each fetch of
``dynslice_fetch``; OK or WRONG for ``aligned_dynslice`` and
``scalar_from_vmem``; ``exact=``, ``bad=`` and ``max rel err`` for each
table height of ``select_rows``, then ``exact=`` and ``bad=`` on a table
of general float32 values (random bit patterns, compared as bits).  On
the card each line also holds the kernel held against its plain version
(``kernel == plain``), the plain version's time and, where one PyTorch
call computes the same function, that call's time.  Times are per launch, on the card's clock: the median
over 5 batches of CUDA events around 20 launches queued behind a spin
kernel, so that the host's enqueue is hidden; the host's enqueue time per
launch (the wrapper's cost) is printed beside the kernel's.  On the CPU the plain
versions run and no time is printed.  Exits 1 if a kernel differs from
its plain version or a probe's answer is WRONG.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import torch

from meshflow_tpu_torch.probes import (
    aligned_dynslice,
    dynslice_fetch,
    scalar_from_vmem,
    select_rows,
)
from meshflow_tpu_torch.probes._slices import dyn_start

PROBES = ("dynslice_fetch", "aligned_dynslice", "select_rows", "scalar_from_vmem")


def event_ms(fn, launches: int = 20, batches: int = 5):
    """(device ms, host ms) per call of `fn`.  The host time is the wall
    time to enqueue `launches` calls, over their number.  The device time
    is the median over `batches` of CUDA events around `launches` calls
    queued behind a spin kernel (``torch.cuda._sleep``) that outlasts
    their enqueue, so the card runs them back to back and the host's cost
    per call is hidden (as far as the launch queue holds them)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(launches):
        fn()
    host = (time.perf_counter() - start) / launches
    torch.cuda.synchronize()
    spin = int(min(2.0, 1.5 * host * launches + 1e-3) * 2e9)  # cycles, at <= 2 GHz
    times = []
    for _ in range(batches):
        torch.cuda._sleep(spin)
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        begin.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(begin.elapsed_time(end) / launches)
    return sorted(times)[len(times) // 2], host * 1e3


def max_abs_err(got, want) -> float:
    """Largest absolute difference over tensors (or tuples of tensors)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max((g - w).abs().max().item() for g, w in zip(got, want))


def _timed(device, kernel, plain, library=None) -> dict:
    """Times of the kernel, the plain version and the library call, on
    the card only."""
    if device.type != "cuda":
        return {"ms": None, "plain_ms": None, "library_ms": None, "host_ms": None}
    ms, host_ms = event_ms(kernel)
    return {
        "ms": ms, "host_ms": host_ms,
        "plain_ms": event_ms(plain, launches=2, batches=3)[0],
        "library_ms": None if library is None else event_ms(library)[0],
    }


def _result(kernel, case, got, want, times, ok=True, **extra) -> dict:
    err = max_abs_err(got, want)
    return {"kernel": kernel, "case": case, "ok": ok and err == 0.0,
            "max_abs_err": err, **times, **extra}


def _us(ms, per=1):
    return f"{ms * 1e3 / per:.2f} us" if ms is not None else "-"


def run_dynslice_fetch(device) -> list:
    d = dynslice_fetch
    cases = (
        [("dynslice copies", "dynslice_copy", b) for b in d.SIZES]
        + [("dynslice+fine-rowsel", "dynslice_fine", b) for b in d.SIZES]
        + [("full-plane one-hot rowsel", "onehot_rowsel", 16)]
    )
    results = []
    for label, name, b in cases:
        idx, plane = (t.to(device) for t in d.probe_inputs(b))
        args = (idx, plane)
        library = bmm = None
        if name == "dynslice_fine":
            rsel = d.one_hot_rsel(b).to(device)
            args += (rsel,)
            index = [d.band_index(idx, r, *plane.shape) for r in range(d.REPS)]

            def library():
                return [torch.bmm(rsel, plane[rows, cols]) for rows, cols in index]
        if name == "dynslice_copy":
            index = [d.band_index(idx, r, *plane.shape) for r in range(d.REPS)]

            def library():
                return [plane[rows, cols] for rows, cols in index]
        if name == "onehot_rowsel":
            k = torch.arange(b * d.PN, device=device) % d.PN
            rows = [idx[0].long() + r % 4 + k for r in range(d.REPS)]

            def library():
                return [plane.index_select(0, r) for r in rows]
        kernel, plain = getattr(d, name), getattr(d, name + "_plain")
        got, want = kernel(*args), plain(*args)
        times = _timed(device, lambda: kernel(*args), lambda: plain(*args), library)
        if name == "dynslice_fine" and device.type == "cuda":
            bands = want[1]
            bmm = event_ms(lambda: [torch.bmm(args[2], bands) for _ in range(d.REPS)])[0]
        res = _result(name, f"B={b}", got, want, times, bmm_ms=bmm)
        results.append(res)
        if times["ms"] is None:
            print(f"{label} (B={b}): plain version on {device.type}, out sum "
                  f"{got[0].sum().item():.4f}", flush=True)
            continue
        extra = f" (bmm alone {_us(bmm, d.REPS)}/round)" if bmm is not None else ""
        print(
            f"{label} (B={b}): {_us(times['ms'], d.REPS)}/round "
            f"({_us(times['ms'], d.REPS * b)}/feature); plain {_us(times['plain_ms'], d.REPS)}"
            f"/round; library {_us(times['library_ms'], d.REPS)}/round{extra}; host enqueue "
            f"{_us(times['host_ms'])}/launch; kernel == plain: {res['ok']}",
            flush=True,
        )
    return results


def run_aligned_dynslice(device) -> list:
    e = aligned_dynslice
    plane, r0 = (t.to(device) for t in e.probe_inputs())
    got, want = e.aligned_rows(plane, r0), e.aligned_rows_plain(plane, r0)
    ok = bool(torch.equal(got, plane[e.PROBE_ROW : e.PROBE_ROW + e.ROWS]))
    base = (e.PROBE_ROW // 8) * 8
    start = dyn_start(base, e.H, e.BAND) + e.PROBE_ROW - base
    times = _timed(device, lambda: e.aligned_rows(plane, r0), lambda: e.aligned_rows_plain(plane, r0),
                   lambda: plane[start : start + e.ROWS].clone())
    res = _result("aligned_dynslice", f"r0={e.PROBE_ROW}", got, want, times, ok=ok)
    line = f"device={device.type}: aligned-dynamic-slice {'OK' if ok else 'WRONG'}"
    if times["ms"] is not None:
        line += (f"; kernel {_us(times['ms'])} (host enqueue {_us(times['host_ms'])}), plain "
                 f"{_us(times['plain_ms'])}, library {_us(times['library_ms'])}; "
                 f"kernel == plain: {res['ok']}")
    print(line, flush=True)
    return [res]


def run_select_rows(device) -> list:
    f = select_rows
    results = []
    for nrows in f.ROW_COUNTS:
        table, cells = (t.to(device) for t in f.probe_inputs(nrows))
        got, want = f.select_rows(table, cells), f.select_rows_plain(table, cells)
        exact, bad, size, rel = f.select_report(got, want)
        times = _timed(device, lambda: f.select_rows(table, cells),
                       lambda: f.select_rows_plain(table, cells),
                       lambda: torch.index_select(table, 1, cells[0]))
        res = _result("select_rows", f"rows={nrows}", got, want, times, ok=exact, max_rel_err=rel)
        results.append(res)
        line = f"rows={nrows:4d}: exact={exact}  bad={bad}/{size}  max rel err={rel:.3e}"
        if times["ms"] is not None:
            line += (f"; kernel {_us(times['ms'])} (host enqueue {_us(times['host_ms'])}), "
                     f"plain {_us(times['plain_ms'])}, library {_us(times['library_ms'])}")
        print(line, flush=True)
    # any float32 bit pattern: compared as bits, since NaN != NaN
    nrows = f.ROW_COUNTS[-1]
    table, cells = f.general_table(nrows).to(device), cells.to(device)
    got, want = (x.view(torch.int32) for x in (f.select_rows(table, cells),
                                                f.select_rows_plain(table, cells)))
    bad = int((got != want).sum())
    times = _timed(device, lambda: f.select_rows(table, cells),
                   lambda: f.select_rows_plain(table, cells))
    results.append(_result("select_rows", f"rows={nrows} float32", got, want, times))
    line = (f"rows={nrows:4d}, general float32 (random bit patterns): exact={bad == 0}  "
            f"bad={bad}/{got.numel()}")
    if times["ms"] is not None:
        line += f"; kernel {_us(times['ms'])}, plain {_us(times['plain_ms'])}"
    print(line, flush=True)
    return results


def run_scalar_from_vmem(device) -> list:
    g = scalar_from_vmem
    plane, corners = (t.to(device) for t in g.probe_inputs())
    got, want = g.band_row(plane, corners), g.band_row_plain(plane, corners)
    # the probe's own expectation: its corners keep every base inside the plane
    rows = [(math.floor(c * 2 + 1) // 8) * 8 for c in corners[:, 0].tolist()]
    ok = bool(torch.equal(got, plane[rows][:, None, :]))
    times = _timed(device, lambda: g.band_row(plane, corners),
                   lambda: g.band_row_plain(plane, corners))
    res = _result("scalar_from_vmem", f"B={g.B}", got, want, times, ok=ok)
    line = f"device={device.type}: scalar handoff {'OK' if ok else 'WRONG'}"
    if times["ms"] is not None:
        line += (f"; kernel {_us(times['ms'])} (host enqueue {_us(times['host_ms'])}), plain "
                 f"{_us(times['plain_ms'])}, library none; kernel == plain: {res['ok']}")
    print(line, flush=True)
    return [res]


RUNNERS = {
    "dynslice_fetch": run_dynslice_fetch,
    "aligned_dynslice": run_aligned_dynslice,
    "select_rows": run_select_rows,
    "scalar_from_vmem": run_scalar_from_vmem,
}


def run(names=PROBES, device="cuda") -> list:
    """Every named probe's results: one dict per kernel and case, with
    its kernel name, case, ok, max_abs_err, ms, plain_ms and library_ms
    (times None off the card)."""
    device = torch.device(device)
    results = []
    for name in names:
        print(f"== {name} ({device.type})", flush=True)
        results += RUNNERS[name](device)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m meshflow_tpu_torch.probes",
        description="The TPU probes' questions, asked of the CUDA card",
    )
    parser.add_argument("probes", nargs="*", choices=PROBES, metavar="PROBE",
                        help=f"probes to run, of {', '.join(PROBES)} (default: all)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain versions)")
    args = parser.parse_args(argv)
    results = run(args.probes or PROBES, args.device)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
