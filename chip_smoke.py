#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card:

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels from ``meshflow_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernel A (LK level): the kernel against its plain PyTorch version on
   the card, at the main path's shapes (16 tiles of 90x160, 3 channels,
   512 slots, 3 levels, 8 pairs of textured tiles with known shifts);
4. kernel B (backward map): the kernel against its plain version on a
   64-frame 640x360 block with a 16x16 mesh (the main path's launch),
   and on single frames with a heavy warp and at 1920x1080 with a 64x64
   mesh;
5. the main path: ``MeshFlowStabilizer(device="cuda")._stabilize_frames``
   on a synthetic 300-frame 640x360 clip (seeded texture, smooth pan and
   per-frame jitter), cold then warm, with every kernel's launch count;
6. the same path on a small clip on the card and on the CPU (plain
   versions), whose outputs must agree.

Prints one JSON line of the kernels' launches, errors and times, then the
last line ``{"ok": true, "device": {...}}``.  Any failed check or error
exits non-zero before that line.  Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 0


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def median_ms(fn, reps: int = 5) -> float:
    """Median wall time of fn() over reps runs after one warm-up, each
    ended by a device synchronize."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return sorted(times)[len(times) // 2]


def blurred_noise(rng, shape, passes: int = 2):
    """Seeded uint8 texture: integer noise smoothed by [1 2 1]/4 passes."""
    import numpy as np

    base = rng.integers(0, 256, shape).astype(np.float32)
    for _ in range(passes):
        for ax in (0, 1):
            base = 0.25 * np.roll(base, 1, ax) + 0.5 * base + 0.25 * np.roll(base, -1, ax)
    return base


def phase_kernel_a(device):
    """LK kernel vs plain LK on the card at the slice's shapes."""
    import numpy as np
    import torch

    from meshflow_tpu_torch.kernels import lk_cuda
    from meshflow_tpu_torch.kernels.lk import reflect_pad_level
    from meshflow_tpu_torch.kernels.pyramid import build_pyramid, pyramid_shapes

    rng = np.random.default_rng(SEED)
    pairs, s, c, k, th, tw, max_level = 8, 16, 3, 512, 90, 160, 2
    base = blurred_noise(rng, (th + 80, tw + 80, c))
    shifts = [(0, 0)] + [tuple(rng.integers(-6, 7, 2)) for _ in range(pairs)]
    tiles = np.zeros((pairs + 1, s, c, th, tw), np.float32)
    for t, (dy, dx) in enumerate(shifts):
        for si in range(s):
            oy, ox = 30 + dy + (si % 4), 30 + dx - (si // 4)
            tiles[t, si] = base[oy : oy + th, ox : ox + tw].transpose(2, 0, 1)
    tiles = torch.from_numpy(np.round(tiles)).to(device)
    planes = tuple(
        reflect_pad_level(lvl).to(torch.uint8)
        for lvl in build_pyramid(tiles, max_level)
    )
    dims = tuple(pyramid_shapes(th, tw, max_level))
    pts = np.stack(
        [rng.uniform(3, tw - 4, (pairs + 1, s, k)), rng.uniform(3, th - 4, (pairs + 1, s, k))],
        axis=-1,
    ).astype(np.float32)
    pts = torch.from_numpy(pts).to(device)
    valid = torch.from_numpy(rng.random((pairs + 1, s, k)) < 0.9).to(device)

    def run(level_fn):
        return lk_cuda.lk_track_pairs(planes, dims, pts, valid, level_fn=level_fn)

    kp, kst = run(lk_cuda.lk_level)
    pp, pst = run(lk_cuda.lk_level_plain)
    torch.cuda.synchronize()
    v = valid[:-1]
    agree = (kst == pst)[v].float().mean().item()
    both = kst & pst
    dist = torch.linalg.norm(kp - pp, dim=-1)[both]
    p99 = torch.quantile(dist, 0.99).item()
    max_err = dist.max().item()
    inv = ~v
    untouched = bool(torch.equal(kp[inv], pts[:-1][inv])) and not bool(kst[inv].any())
    # known shifts: pair t moves content by -(shift[t+1] - shift[t])
    expect = torch.tensor(
        [[-(shifts[t + 1][1] - shifts[t][1]), -(shifts[t + 1][0] - shifts[t][0])]
         for t in range(pairs)], dtype=torch.float32, device=device,
    )[:, None, None, :]
    motion = (kp - pts[:-1])[both[..., None].expand_as(kp)].reshape(-1, 2)
    err_shift = torch.median(
        torch.linalg.norm((kp - pts[:-1] - expect)[both], dim=-1)
    ).item()
    ms = median_ms(lambda: run(lk_cuda.lk_level))
    plain_ms = median_ms(lambda: run(lk_cuda.lk_level_plain))
    print(
        f"kernel A: valid {int(v.sum())} status agreement {agree:.5f} "
        f"p99 endpoint {p99:.6f} px max {max_err:.6f} px "
        f"median |track - known shift| {err_shift:.4f} px, tracked "
        f"{int(both.sum())} (mean motion {motion.mean(0).tolist()}); "
        f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms (3 levels, {pairs} pairs)"
    )
    check(agree >= 0.99, f"kernel A status agreement {agree} < 0.99")
    check(p99 <= 0.02, f"kernel A p99 endpoint distance {p99} > 0.02 px")
    check(untouched, "kernel A changed invalid slots")
    check(err_shift < 0.1, f"kernel A misses the known shifts by {err_shift} px")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def phase_kernel_b(device):
    """Backward-map kernel vs plain backward map on the card."""
    import numpy as np
    import torch

    from meshflow_tpu_torch.config import MeshFlowConfig
    from meshflow_tpu_torch.kernels import bmap_cuda
    from meshflow_tpu_torch.render.stabilize import crop_edges
    from meshflow_tpu_torch.utils import grid

    out = {}
    max_err = 0.0
    # (width, height, mesh, vertex noise sigma, frames per launch); the
    # first case is the main path's launch: a 64-frame block at 640x360
    for name, (w, h, mesh, sigma, frames) in {
        "640x360/16/s1.5/x64": (640, 360, 16, 1.5, 64),
        "640x360/16/s12": (640, 360, 16, 12.0, 1),
        "1920x1080/64/s3": (1920, 1080, 64, 3.0, 1),
    }.items():
        config = MeshFlowConfig(mesh_row_count=mesh, mesh_col_count=mesh)
        rng = np.random.default_rng(SEED + mesh + int(sigma))
        unstab = grid.vertex_grid(config, h, w, device=device)
        shape = (frames,) + tuple(unstab.shape) if frames > 1 else tuple(unstab.shape)
        noise = rng.normal(0.0, sigma, shape).astype(np.float32)
        stab = unstab + torch.from_numpy(noise).to(device)
        kb = bmap_cuda.backward_map(stab, unstab, config, h, w)
        pb = bmap_cuda.backward_map_plain(stab, unstab, config, h, w)
        torch.cuda.synchronize()
        cov_equal = bool(torch.equal(kb.covered, pb.covered))
        cov = pb.covered
        err = max(
            (kb.map_x - pb.map_x)[cov].abs().max().item(),
            (kb.map_y - pb.map_y)[cov].abs().max().item(),
        )
        edges_equal = bool(torch.equal(crop_edges(kb, h, w), crop_edges(pb, h, w)))
        ms = median_ms(lambda: bmap_cuda.backward_map(stab, unstab, config, h, w))
        plain_ms = median_ms(lambda: bmap_cuda.backward_map_plain(stab, unstab, config, h, w))
        print(
            f"kernel B {name}: covered equal {cov_equal} "
            f"(uncovered {int((~cov).sum())} px), max map err {err:.3g}, "
            f"crop edges equal {edges_equal}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms"
        )
        check(cov_equal, f"kernel B coverage differs ({name})")
        check(err <= 1e-4, f"kernel B map error {err} > 1e-4 ({name})")
        check(edges_equal, f"kernel B crop edges differ ({name})")
        max_err = max(max_err, err)
        if frames > 1:
            out = {"ms": ms, "plain_ms": plain_ms}
    out["max_abs_err"] = max_err
    return out


def synthetic_clip(num_frames: int, h: int, w: int, pan: int):
    """Seeded BGR clip: integer-shift crops of one textured canvas, a smooth
    pan of `pan` px to the right over the clip plus +-3 px jitter."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    margin = 40
    small = rng.integers(0, 256, ((h + 2 * margin) // 4 + 1, (w + pan + 2 * margin) // 4 + 1, 3))
    canvas = np.repeat(np.repeat(small, 4, 0), 4, 1).astype(np.float32)
    for _ in range(2):
        for ax in (0, 1):
            canvas = 0.25 * np.roll(canvas, 1, ax) + 0.5 * canvas + 0.25 * np.roll(canvas, -1, ax)
    canvas = np.round(canvas).astype(np.uint8)
    frames = np.empty((num_frames, h, w, 3), np.uint8)
    for t in range(num_frames):
        jx, jy = rng.integers(-3, 4, 2)
        x0 = margin + int(round(pan * t / max(num_frames - 1, 1))) + jx
        y0 = margin + jy
        frames[t] = canvas[y0 : y0 + h, x0 : x0 + w]
    return frames


def phase_main_path(device, num_frames=300, h=360, w=640, pan=120):
    """The port's main path on a 300-frame 640x360 clip, cold then warm."""
    import math

    import torch

    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.kernels import bmap_cuda, lk_cuda

    frames = torch.from_numpy(synthetic_clip(num_frames, h, w, pan=pan)).to(device)
    stab = MeshFlowStabilizer(device=device)
    variant = MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL

    lk_cuda.lk_level.launches = 0
    bmap_cuda.backward_map.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    cropped, ratio, distortion, stability = stab._stabilize_frames(frames, variant)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - start
    launches = {"lk_level": lk_cuda.lk_level.launches,
                "backward_map": bmap_cuda.backward_map.launches}

    start = time.perf_counter()
    cropped2, *_ = stab._stabilize_frames(frames, variant)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - start

    chunk = stab.CHUNK
    levels = stab.config.lk_max_level(h, w) + 1
    motion_blocks = math.ceil((num_frames - 1) / (chunk - 1))
    metric_blocks = math.ceil(num_frames / chunk)
    crop = stab.last_crop.tolist()
    disp = stab.last_motion.displacements
    mean_dx = disp[-1, ..., 0].mean().item()
    ratio, distortion, stability = float(ratio), float(distortion), float(stability)
    print(
        f"main path: {num_frames} frames {w}x{h}: cold {cold_s:.3f} s, warm "
        f"{warm_s:.3f} s ({num_frames / warm_s:.2f} fps warm); launches {launches}; "
        f"crop {crop}; cropping ratio {ratio:.6f}, distortion {distortion:.6f}, "
        f"stability {stability:.6f}; last-frame mean x displacement {mean_dx:.3f} px"
    )
    check(
        launches["lk_level"] == levels * (motion_blocks + metric_blocks),
        f"kernel A ran {launches['lk_level']} times, expected "
        f"{levels} levels x ({motion_blocks} motion + {metric_blocks} metric blocks)",
    )
    check(launches["backward_map"] == metric_blocks, "kernel B launch count")
    check(
        tuple(cropped.shape) == (num_frames, h, w, 3)
        and cropped.dtype == torch.uint8 and cropped.device.type == device,
        f"output {tuple(cropped.shape)} {cropped.dtype} {cropped.device}",
    )
    check(torch.equal(cropped, cropped2), "warm pass output differs from cold pass")
    left, top, right, bottom = crop
    check(0 <= left < right <= w - 1 and 0 <= top < bottom <= h - 1, f"crop {crop}")
    check(all(math.isfinite(x) for x in (ratio, distortion, stability)), "metrics not finite")
    check(0.0 <= stability <= 1.0, f"stability {stability} outside [0, 1]")
    # the camera pans right, so content (and the vertex displacement) moves left
    check(mean_dx < -pan / 2, f"mean displacement {mean_dx} does not follow the pan")
    return launches, cold_s, warm_s


def phase_small_agreement(device):
    """A small clip through the whole path on the card (kernels) and on the
    CPU (plain versions): same crop, near-equal frames and metrics."""
    import torch

    from meshflow_tpu_torch.api import MeshFlowStabilizer
    from meshflow_tpu_torch.config import MeshFlowConfig

    config = MeshFlowConfig(
        mesh_row_count=8, mesh_col_count=8, mesh_outlier_subframe_row_count=2,
        mesh_outlier_subframe_col_count=2, max_features_per_subframe=128,
    )
    frames = torch.from_numpy(synthetic_clip(12, 180, 320, pan=12))
    outs = {}
    for dev in (device, "cpu"):
        s = MeshFlowStabilizer(config=config, device=dev)
        res = s._stabilize_frames(frames, 0)
        outs[dev] = ([r.cpu() for r in res], s.last_crop.cpu())
    (g, gcrop), (c, ccrop) = outs[device], outs["cpu"]
    mse = ((g[0].double() - c[0].double()) ** 2).mean().item()
    psnr = 99.0 if mse == 0 else 10 * __import__("math").log10(255**2 / mse)
    rel = [abs(float(a) - float(b)) / max(abs(float(b)), 1e-12) for a, b in zip(g[1:], c[1:])]
    print(f"small clip card vs CPU: crop {gcrop.tolist()} vs {ccrop.tolist()}, "
          f"PSNR {psnr:.2f} dB, metric rel diffs {rel}")
    check(torch.equal(gcrop, ccrop), "card and CPU crops differ")
    check(psnr >= 40.0, f"card vs CPU PSNR {psnr} < 40 dB")
    check(max(rel) <= 1e-2, f"card vs CPU metrics differ by {rel}")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "meshflow_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: meshflow_tpu_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")

    import meshflow_tpu_torch  # noqa: F401  (TF32 pins)
    from meshflow_tpu_torch.kernels import _build

    info = _build.build()
    print(f"build: {info['seconds']:.2f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"  ptxas {line.strip()}")
    _build.library()

    device = "cuda"
    a = phase_kernel_a(device)
    b = phase_kernel_b(device)
    launches, cold_s, warm_s = phase_main_path(device)
    phase_small_agreement(device)

    kernels = [
        {"name": "lk_level", "route": "cuda",
         "source": "meshflow_tpu_torch/csrc/lk_level.cu",
         "replaces": "meshflow_tpu/kernels/_lk_pallas_onehot.py:73",
         "launches": launches["lk_level"], **a},
        {"name": "backward_map", "route": "cuda",
         "source": "meshflow_tpu_torch/csrc/bmap.cu",
         "replaces": "meshflow_tpu/kernels/bmap_pallas.py:90",
         "launches": launches["backward_map"], **b},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
