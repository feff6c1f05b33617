"""The precision of the reference's image arithmetic: LK windows and
gradients, and the warps' and the crop's bilinear sampling.  float32, as
the configurations state; the control of ``compare.py`` sets bfloat16,
the next precision below, beside TF32 matmuls."""

import torch

IMAGE = torch.float32
