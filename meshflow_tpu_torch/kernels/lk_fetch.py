"""LK fetch-route dispatcher: the counterpart of the JAX package's
``meshflow_tpu/kernels/lk_pallas.py``.

``MESHFLOW_LK_FETCH`` selects the kernel every tracker of the port runs
on a CUDA tensor:

* ``onehot`` (the default): kernel A, ``lk_cuda.lk_level``
  (``csrc/lk_level.cu``), taps read from the plane through the read-only
  cache;
* ``band``: kernel C, ``lk_band_cuda.lk_level_band`` (``csrc/lk_band.cu``),
  taps read from a patch staged in shared memory, ``PN_TOP`` at the
  tracker's top level and ``PN_LOWER`` below.

The value is stripped and lower-cased; any other value raises ValueError.
CPU tensors take the plain version ``lk_level_plain`` on either route and
neither launch counter moves.  The variable is read at each tracker call,
not at import as in the JAX package: there the two routes pad their
planes differently, here both kernels read the same PAD=28 REFLECT_101
planes.
"""

from __future__ import annotations

import functools
import os

from meshflow_tpu_torch.kernels.lk_band_cuda import PN_LOWER, PN_TOP, lk_level_band
from meshflow_tpu_torch.kernels.lk_cuda import lk_level

ROUTES = ("onehot", "band")


def fetch_route() -> str:
    """The route ``MESHFLOW_LK_FETCH`` names now."""
    route = os.environ.get("MESHFLOW_LK_FETCH", "onehot").strip().lower()
    if route not in ROUTES:
        raise ValueError(f"MESHFLOW_LK_FETCH={route!r}: expected 'onehot' or 'band'")
    return route


def level_function(route: str, top: bool):
    """The level function of `route` for a tracker level (top: the
    coarsest level of the pyramid)."""
    if route == "onehot":
        return lk_level
    if route == "band":
        return functools.partial(lk_level_band, patch=PN_TOP if top else PN_LOWER)
    raise ValueError(f"unknown LK fetch route {route!r}")
