"""The TPU probes of ``scripts/probe_*.py``, ported to Hopper.

Each probe asks one question of the hardware that a redesign of the LK or
backward-map kernels needs answered; each module holds the kernel
wrapper(s) of one probe script, with a ``.launches`` count, and the plain
PyTorch version of the same function (``*_plain``), which the wrapper
takes for CPU tensors:

- ``dynslice_fetch`` (D): a per-feature band fetch staged in shared
  memory against a full-plane one-hot row select, at 1080p level-0 tile
  geometry, as the feature block grows;
- ``aligned_dynslice`` (E): an 8-row-aligned dynamic band load plus a
  small shift selects the 16 rows at a dynamic row;
- ``select_rows`` (F): a one-hot select on the tensor cores, exact or not
  as the row count grows;
- ``scalar_from_vmem`` (G): a per-feature scalar handed from a value
  computed in the kernel to an address (a warp shuffle).

The kernels are CUDA C++ in ``csrc/probe_*.cu`` with the shared
``csrc/probes.cuh``.  Run every probe on the card with
``python -m meshflow_tpu_torch.probes`` (``--device cpu`` runs the plain
versions).
"""

from meshflow_tpu_torch.probes import (  # noqa: F401
    aligned_dynslice,
    dynslice_fetch,
    scalar_from_vmem,
    select_rows,
)

__all__ = ["aligned_dynslice", "dynslice_fetch", "scalar_from_vmem", "select_rows"]
