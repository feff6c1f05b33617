"""PyTorch port: the slice at the JAX package's other clip geometries
against JAX ``_stabilize_frames`` (MESHFLOW_RENDER=device), through
``tests/test_torch_trackscale.py``'s ``compare_track_slice``:

* ``track_downscale=5``, the factor a 3840x2160 clip resolves to (it
  tracks at 768x432 in subframes of 108x192), on a 360x640 clip;
* the 64x64 mesh (the JAX package's 1080p mesh stress), where the ellipse
  membership of the motion stage holds 16.5x the vertices, on a 180x320
  clip.

Both with the small subframe config of the slice tests.  Tolerances, those
of tests/test_torch_slice.py: track planes, keypoints and the crop exact,
solved displacements within 0.05 px, PSNR >= 40 dB, stability within 1e-3
relative, cropping ratio and distortion within 1e-2 relative.
"""

import pytest

import meshflow_tpu  # noqa: F401  (precision pins)
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)
from test_torch_trackscale import TINY, compare_track_slice


@pytest.mark.parametrize("fields,num_frames,h,w", [
    pytest.param(dict(TINY, track_downscale=5), 8, 360, 640, id="track_downscale_5"),
    pytest.param(dict(TINY, mesh_row_count=64, mesh_col_count=64), 6, 180, 320,
                 id="mesh_64x64"),
])
def test_geometry_matches_jax(monkeypatch, fields, num_frames, h, w):
    compare_track_slice(monkeypatch, fields, num_frames, h, w)

