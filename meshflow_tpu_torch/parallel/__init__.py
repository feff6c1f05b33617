"""Multi-device paths: the port of ``meshflow_tpu/parallel/``.

* ``pipeline.stabilize_sharded``: one clip's frames sharded over a list
  of devices, one process a shard, its collectives through
  ``torch.distributed``;
* ``batch.stabilize_batch``: independent clips fanned out over devices,
  one worker process a device.

Both run their processes from ``workers.pool``: one spawned child for
each entry of the device list, kept for later calls with the same list.
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


def device_list(devices=None) -> list:
    """`devices` as torch devices, a CUDA entry without an index taken as
    the current card (default: every CUDA device); ValueError when empty."""
    if devices is None:
        return cuda_devices()
    out = []
    for d in map(torch.device, devices):
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        out.append(d)
    if not out:
        raise ValueError("an empty device list")
    return out
