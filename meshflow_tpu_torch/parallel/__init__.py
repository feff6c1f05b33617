"""Multi-device paths: the port of ``meshflow_tpu/parallel/``.

* ``pipeline.stabilize_sharded``: one clip's frames sharded over a list
  of devices, in one process;
* ``batch.stabilize_batch``: independent clips fanned out over devices,
  one worker thread a device.

A device may repeat in either list, so one card (or the CPU) can run
several logical shards or workers.  With no list, both take every CUDA
device and raise when there is none; they never fall back to the CPU.
"""

from __future__ import annotations

import torch


def cuda_devices() -> list:
    """Every CUDA device of this process; RuntimeError when there is none."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device: pass devices=[...] to run elsewhere")
    return [torch.device("cuda", i) for i in range(count)]
