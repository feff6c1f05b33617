"""Static configuration of the stabilization pipeline.

Same fields, defaults, validation and derived geometry as
``meshflow_tpu/config.py``; a frozen dataclass so that one value
describes one pipeline and can be compared or hashed.  The field comments
there give the reasons behind each default.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL = 0
ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED = 1
ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH = 2
ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW = 3

ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH_VALUE = 100
ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW_VALUE = 1

_VALID_DEFINITIONS = (
    ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL,
    ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED,
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH,
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW,
)


@dataclasses.dataclass(frozen=True)
class MeshFlowConfig:
    """Pipeline configuration; defaults mirror the reference constructor."""

    # --- reference hyperparameters -------------------------------------
    mesh_row_count: int = 16
    mesh_col_count: int = 16
    mesh_outlier_subframe_row_count: int = 4
    mesh_outlier_subframe_col_count: int = 4
    feature_ellipse_row_count: int = 10
    feature_ellipse_col_count: int = 10
    homography_min_number_corresponding_features: int = 4
    temporal_smoothing_radius: int = 10
    optimization_num_iterations: int = 100
    color_outside_image_area_bgr: Tuple[int, int, int] = (0, 0, 255)
    visualize: bool = False

    # --- fixed-shape knobs (no reference counterpart) -------------------
    # FAST: OpenCV FastFeatureDetector_create() defaults.
    fast_threshold: int = 10
    # Per-subframe feature capacity (top-K by FAST score).
    max_features_per_subframe: int = 512
    # calcOpticalFlowPyrLK defaults; the pyramid depth is clamped from the
    # subframe size (lk_max_level()).
    lk_window_size: int = 21
    lk_max_level_cap: int = 3
    lk_max_iterations: int = 30
    lk_epsilon: float = 0.01
    lk_min_eig_threshold: float = 1e-4
    # Fixed-iteration seeded RANSAC (reprojection threshold 3.0).
    ransac_iterations: int = 256
    ransac_reproj_threshold: float = 3.0
    ransac_seed: int = 0
    # LO-RANSAC inlier polish rounds.
    ransac_polish_rounds: int = 2
    # Gauss-Newton iterations for least-squares homographies.
    homography_refine_iterations: int = 10
    # Box-downscale factor of the motion stages; 0 = auto from the pixel
    # budget (1 up to ~480p).
    track_downscale: int = 0
    # Pixel planes the trackers consume: "bgr" (reference) or "gray".
    track_planes: str = "bgr"
    # Serving mode: False skips the cropping/distortion evaluation pass.
    compute_metrics: bool = True

    def __post_init__(self):
        if self.mesh_row_count < 1 or self.mesh_col_count < 1:
            raise ValueError("mesh dimensions must be positive")
        if self.temporal_smoothing_radius < 1:
            raise ValueError("temporal_smoothing_radius must be positive")
        if self.track_planes not in ("bgr", "gray"):
            raise ValueError("track_planes must be 'bgr' or 'gray'")
        if self.track_downscale < 0:
            raise ValueError("track_downscale must be >= 0 (0 = auto)")

    TRACK_PIXEL_BUDGET = int(854 * 480 * 1.05)

    def resolve_track_downscale(self, frame_height: int, frame_width: int) -> int:
        """Concrete box-downscale factor for this frame geometry."""
        if self.track_downscale:
            return self.track_downscale
        d = 1
        while (frame_height // d) * (frame_width // d) > self.TRACK_PIXEL_BUDGET:
            d += 1
        return d

    def track_shape(self, frame_height: int, frame_width: int) -> Tuple[int, int]:
        """(track_height, track_width) the motion stages run at."""
        d = self.resolve_track_downscale(frame_height, frame_width)
        return frame_height // d, frame_width // d

    # --- derived static geometry ---------------------------------------
    @property
    def vertex_rows(self) -> int:
        return self.mesh_row_count + 1

    @property
    def vertex_cols(self) -> int:
        return self.mesh_col_count + 1

    @property
    def num_vertices(self) -> int:
        return self.vertex_rows * self.vertex_cols

    @property
    def num_subframes(self) -> int:
        return (
            self.mesh_outlier_subframe_row_count
            * self.mesh_outlier_subframe_col_count
        )

    @property
    def max_features_per_frame(self) -> int:
        return self.num_subframes * self.max_features_per_subframe

    def subframe_shape(self, frame_height: int, frame_width: int) -> Tuple[int, int]:
        """(height, width) of a subframe: the reference's ceil split."""
        return (
            math.ceil(frame_height / self.mesh_outlier_subframe_row_count),
            math.ceil(frame_width / self.mesh_outlier_subframe_col_count),
        )

    def lk_max_level(self, frame_height: int, frame_width: int) -> int:
        """LK pyramid max level, clamped like OpenCV's
        buildOpticalFlowPyramid on a subframe: a level is usable only while
        both of its dimensions exceed the window."""
        sub_h, sub_w = self.subframe_shape(frame_height, frame_width)
        level = 0
        h, w = sub_h, sub_w
        while level < self.lk_max_level_cap:
            h, w = (h + 1) // 2, (w + 1) // 2
            if h <= self.lk_window_size or w <= self.lk_window_size:
                break
            level += 1
        return level


def validate_adaptive_weights_definition(adaptive_weights_definition: int) -> None:
    """Raise the reference's ValueError for an invalid variant."""
    if adaptive_weights_definition not in _VALID_DEFINITIONS:
        raise ValueError(
            "Invalid value for `adaptive_weights_definition`. Expecting value of "
            "`MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL`, "
            "`MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED`, "
            "`MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH`, or"
            "`MeshFlowStabilizer.ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW`."
        )
