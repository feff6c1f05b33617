"""meshflow_tpu_torch — the MeshFlow stabilizer on PyTorch and CUDA.

A port of the JAX package ``meshflow_tpu`` to PyTorch, with the two
device kernels of the main path (one pyramid level of sparse Lucas-Kanade
tracking, and the per-pixel backward map of the mesh warp) written by
hand in CUDA C++ for Hopper (``csrc/``).  Same public contract:

    MeshFlowStabilizer(...).stabilize(input_path, output_path,
                                      adaptive_weights_definition=...)
    -> (cropping_ratio, distortion_score, stability_score)

Importing the package needs neither JAX, cv2, nvcc nor a GPU: kernels are
built at their first launch, and video I/O imports cv2 inside its
functions.
"""

import torch as _torch

# The DLT, Gauss-Newton and quad-to-quad solves depend on full float32
# products; TF32 keeps about three decimal digits.  Twin of the JAX
# package's jax_default_matmul_precision="highest" pin.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from meshflow_tpu_torch.config import (  # noqa: E402,F401
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH,
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH_VALUE,
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW,
    ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW_VALUE,
    ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED,
    ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL,
    MeshFlowConfig,
)

__version__ = "0.1.0"

__all__ = [
    "MeshFlowConfig",
    "MeshFlowStabilizer",
    "ADAPTIVE_WEIGHTS_DEFINITION_ORIGINAL",
    "ADAPTIVE_WEIGHTS_DEFINITION_FLIPPED",
    "ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH",
    "ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW",
    "ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_HIGH_VALUE",
    "ADAPTIVE_WEIGHTS_DEFINITION_CONSTANT_LOW_VALUE",
    "__version__",
]


def __getattr__(name):
    if name == "MeshFlowStabilizer":
        from meshflow_tpu_torch.api import MeshFlowStabilizer

        return MeshFlowStabilizer
    raise AttributeError(f"module 'meshflow_tpu_torch' has no attribute {name!r}")
