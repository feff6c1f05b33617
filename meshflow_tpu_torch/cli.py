"""Command-line interface: the port of ``meshflow_tpu/cli.py``, plus
``--device``.

Usage:
    python -m meshflow_tpu_torch.cli INPUT OUTPUT [--variant original] [...]

Runs on the CUDA card unless ``--device cpu`` is given.  ``--no-metrics``
turns serving mode on; without it the stabilizer's own default applies,
so ``MESHFLOW_COMPUTE_METRICS=0`` also turns it on.  The clip streams
through the two-pass pipeline unless ``MESHFLOW_STREAM=0``;
``--checkpoint-dir DIR`` keeps its pass-1 motion state in DIR, so a rerun
of the same clip (under any variant) starts at the solve.
``--track-planes gray`` tracks the frames' exact gray planes (the output
stays BGR); ``--visualize`` takes the in-memory route and shows each
input frame above its output until Q is pressed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from meshflow_tpu_torch import config as cfg

_VARIANTS = {
    "original": cfg.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL,
    "flipped": cfg.ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED,
    "constant-high": cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH,
    "constant-low": cfg.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="meshflow-torch",
        description="MeshFlow video stabilization on PyTorch and CUDA",
    )
    p.add_argument("input", help="path to the unstabilized video")
    p.add_argument("output", help="path for the stabilized video")
    p.add_argument(
        "--variant",
        choices=sorted(_VARIANTS),
        default="original",
        help="adaptive-weights definition (default: original)",
    )
    p.add_argument("--mesh-rows", type=int, default=16)
    p.add_argument("--mesh-cols", type=int, default=16)
    p.add_argument("--subframe-rows", type=int, default=4,
                   help="outlier-subframe row count (default: 4)")
    p.add_argument("--subframe-cols", type=int, default=4,
                   help="outlier-subframe column count (default: 4)")
    p.add_argument("--ellipse-rows", type=int, default=10,
                   help="feature-ellipse height in mesh-cell units (default: 10)")
    p.add_argument("--ellipse-cols", type=int, default=10,
                   help="feature-ellipse width in mesh-cell units (default: 10)")
    p.add_argument("--min-features", type=int, default=4,
                   help="minimum matched features for a pair homography (default: 4)")
    p.add_argument("--temporal-smoothing-radius", type=int, default=10)
    p.add_argument("--optimization-iterations", type=int, default=100)
    p.add_argument("--border-bgr", type=int, nargs=3, default=(0, 0, 255),
                   metavar=("B", "G", "R"),
                   help="color outside the warped image area (default: 0 0 255)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None,
                   help="persist pass-1 motion state here: reruns of the same clip, "
                   "under any variant, resume at the solver")
    p.add_argument("--visualize", action="store_true",
                   help="show each input frame above its output after the run, "
                   "looping until Q (needs a display; takes the in-memory route)")
    p.add_argument("--track-planes", choices=("bgr", "gray"), default="bgr",
                   help="planes the feature trackers consume: 'bgr' (default, the "
                   "reference's) or 'gray' (one exact cv2 gray plane; the output "
                   "stays BGR)")
    p.add_argument("--no-metrics", action="store_true",
                   help="serving mode: skip the cropping-ratio/distortion evaluation "
                   "pass; those two scores print as NaN, the output video is "
                   "bit-identical")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")
    p.add_argument("--json", action="store_true", help="print metrics as one JSON line")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from meshflow_tpu_torch.api import MeshFlowStabilizer

    stabilizer = MeshFlowStabilizer(
        track_planes=args.track_planes,
        mesh_row_count=args.mesh_rows,
        mesh_col_count=args.mesh_cols,
        mesh_outlier_subframe_row_count=args.subframe_rows,
        mesh_outlier_subframe_col_count=args.subframe_cols,
        feature_ellipse_row_count=args.ellipse_rows,
        feature_ellipse_col_count=args.ellipse_cols,
        homography_min_number_corresponding_features=args.min_features,
        temporal_smoothing_radius=args.temporal_smoothing_radius,
        optimization_num_iterations=args.optimization_iterations,
        color_outside_image_area_bgr=tuple(args.border_bgr),
        visualize=args.visualize,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        compute_metrics=False if args.no_metrics else None,
        device=args.device,
    )
    t0 = time.perf_counter()
    cropping_ratio, distortion_score, stability_score = stabilizer.stabilize(
        args.input, args.output, _VARIANTS[args.variant]
    )
    elapsed = time.perf_counter() - t0
    if args.json:
        print(json.dumps({
            "cropping_ratio": cropping_ratio,
            "distortion_score": distortion_score,
            "stability_score": stability_score,
            "seconds": elapsed,
        }))
    else:
        print("cropping ratio:", cropping_ratio)
        print("distortion score:", distortion_score)
        print("stability score:", stability_score)
        print(f"elapsed: {elapsed:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
