"""The plain reference the benchmark holds meshflow_tpu_torch against.

A frozen copy of the port's plain PyTorch route (the modules named in each
file's first line), edited only so that it runs on its own: no CUDA
kernel, no CUDA graph, ``torch.linalg.eigh`` for the DLT's null vector,
and an LK level that iterates on its active slots only.  It imports
nothing of ``meshflow_tpu_torch`` or of the JAX package, takes the same
host clips and seed as the program, and works out everything else again,
the PRNG key tree of RANSAC's draws included.  ``offline.stabilize_clip``
is ``MeshFlowStabilizer._stabilize_frames``; ``online.stabilize_stream``
is a session of ``OnlineMeshFlowStabilizer.process``, batched: every
frame's motion first, then the causal solve frame by frame, then the
warps.
"""
