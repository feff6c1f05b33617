"""What decides ``correct``: the program's outputs against the plain
reference's on the same inputs.

Each number compared is a gap, 0 where the two agree, held against its
limit in ``limits/<cell>.json``:

* ``frame_rms``: the RMS difference of all output pixels, in 8-bit levels;
* ``worst_frame_rms``: the largest RMS difference of one frame;
* ``crop_px``: the largest difference of the crop rectangle's edges (clip
  cells);
* ``ratio_rel``, ``distortion_rel``, ``stability_rel``: the scores'
  relative differences (clip cells; the serving cells have stability only).

The control (``control=True``) is the reference one precision lower than
the configuration states: TF32 matmuls where it states float32 with TF32
off, and bfloat16 image arithmetic (LK windows and gradients, bilinear
sampling) where it states float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from portbench.reference import config as ref_config
from portbench.reference import lk as ref_lk
from portbench.reference import offline as ref_offline
from portbench.reference import online as ref_online
from portbench.reference import precision as ref_precision


def meshflow_config(cls, cfg: dict, traffic: dict):
    """A MeshFlowConfig (the program's or the reference's class) from a
    configuration file and a traffic file."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in cfg.items() if k in fields}
    kwargs["compute_metrics"] = bool(traffic.get("scores", True))
    return cls(**kwargs)


@contextlib.contextmanager
def lower_precision(enabled: bool):
    """The control's precision while the block runs, where `enabled`: TF32
    matmuls and convolutions, and the reference's image arithmetic in
    bfloat16 (``reference/precision.py``)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             ref_precision.IMAGE)
    if enabled:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        ref_precision.IMAGE = torch.bfloat16
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         ref_precision.IMAGE) = saved


def reference_clip(clip: np.ndarray, cfg: dict, traffic: dict, device, control=False,
                   lk_work: list | None = None):
    """The reference's output of one clip: (frames on `device`, crop,
    (ratio, distortion, stability)).  lk_work, a list, gets every LK level
    call's work."""
    config = meshflow_config(ref_config.MeshFlowConfig, cfg, traffic)
    ref_lk.work = lk_work
    try:
        with lower_precision(control), torch.no_grad():
            frames, crop, r, d, s = ref_offline.stabilize_clip(
                torch.from_numpy(clip).to(device), config, 0,
                traffic["adaptive_weights_definition"])
    finally:
        ref_lk.work = None
    return frames, crop.cpu().numpy(), (float(r), float(d), float(s))


def reference_session(frames: np.ndarray, cfg: dict, traffic: dict, device, control=False):
    """The reference's frames of one online session, on `device`."""
    config = meshflow_config(ref_config.MeshFlowConfig, cfg, traffic)
    with lower_precision(control), torch.no_grad():
        return ref_online.stabilize_stream(
            torch.from_numpy(frames).to(device), config, 0,
            traffic["adaptive_weights_definition"], traffic["crop_ratio"])


def frame_gaps(prog, ref: torch.Tensor, block: int = 16):
    """(frame_rms, worst_frame_rms) of host frames `prog` against `ref`
    (same shape, on the reference's device)."""
    per_frame = []
    for start in range(0, ref.shape[0], block):
        a = torch.from_numpy(np.ascontiguousarray(prog[start:start + block])).to(ref.device)
        diff = a.to(torch.float32) - ref[start:start + block].to(torch.float32)
        per_frame.append((diff * diff).flatten(1).mean(1).double().cpu())
    ms = torch.cat(per_frame)
    return math.sqrt(float(ms.mean())), math.sqrt(float(ms.max()))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def clip_gaps(prog, ref, scores: bool) -> dict:
    """Gaps of a clip's (frames, crop, scores) against the reference's."""
    rms, worst = frame_gaps(prog[0], ref[0])
    gaps = {"frame_rms": rms, "worst_frame_rms": worst,
            "crop_px": float(np.abs(prog[1].astype(np.int64) - ref[1].astype(np.int64)).max())}
    names = ("ratio_rel", "distortion_rel", "stability_rel")
    for i, name in enumerate(names):
        if scores or name == "stability_rel":
            gaps[name] = _rel(prog[2][i], ref[2][i])
    return gaps


def session_gaps(prog_frames, ref_frames: torch.Tensor) -> dict:
    """Gaps of the frames an online session returned against the
    reference's first frames of that session."""
    rms, worst = frame_gaps(np.stack(prog_frames), ref_frames[:len(prog_frames)])
    return {"frame_rms": rms, "worst_frame_rms": worst}


def judge(gaps: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every gap a number within
    its limit; a gap with no limit, or a limit with no gap, fails."""
    def number(v):
        return None if v is None or v != v else float(v)

    checks = {name: {"value": number(gaps.get(name)), "limit": limit}
              for name, limit in limits.items()}
    for name, value in gaps.items():
        checks.setdefault(name, {"value": number(value), "limit": None})
    correct = all(c["limit"] is not None and c["value"] is not None
                  and c["value"] <= c["limit"] for c in checks.values())
    return correct, checks
