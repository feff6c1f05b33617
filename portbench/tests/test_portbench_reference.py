"""The plain reference against the port on the CPU, where the port runs
its own plain versions: at a small size the two agree to rounding."""

import numpy as np
import torch

from meshflow_tpu_torch.api import MeshFlowStabilizer
from meshflow_tpu_torch.config import MeshFlowConfig
from meshflow_tpu_torch.online import OnlineMeshFlowStabilizer
from portbench import clips, compare
from portbench.reference import config as ref_config
from portbench.tests.layout import TINY


def small(cls):
    return compare.meshflow_config(cls, dict(TINY, height=180, width=320), {"scores": True})


def test_reference_clip_matches_the_port_on_the_cpu():
    torch.set_num_threads(2)
    clip = clips.synthetic_clip([2**32 + 1, 0], 12, 180, 320, pan=60)
    stab = MeshFlowStabilizer(config=small(MeshFlowConfig), device="cpu")
    cropped, ratio, distortion, stability = stab._stabilize_frames(torch.from_numpy(clip), 0)
    traffic = {"scores": True, "adaptive_weights_definition": 0}
    cfg = dict(TINY, height=180, width=320)
    ref = compare.reference_clip(clip, cfg, traffic, "cpu")
    prog = (cropped.numpy(), stab.last_crop.numpy(), (float(ratio), float(distortion),
                                                     float(stability)))
    gaps = compare.clip_gaps(prog, ref, True)
    assert gaps["crop_px"] == 0
    assert gaps["worst_frame_rms"] <= 0.05
    assert max(gaps["ratio_rel"], gaps["distortion_rel"], gaps["stability_rel"]) <= 1e-5
    assert isinstance(small(ref_config.MeshFlowConfig), ref_config.MeshFlowConfig)


def test_reference_session_matches_the_port_on_the_cpu():
    torch.set_num_threads(2)
    frames = clips.synthetic_clip([2**32 + 2, 0], 8, 180, 320, pan=3)
    stab = OnlineMeshFlowStabilizer(config=small(MeshFlowConfig), device="cpu")
    outs = np.stack([stab.process(f) for f in frames])
    traffic = {"adaptive_weights_definition": 0, "crop_ratio": 0.8}
    ref = compare.reference_session(frames, dict(TINY, height=180, width=320), traffic, "cpu")
    assert np.array_equal(outs[0], frames[0])
    diff = np.abs(outs.astype(np.int16) - ref.numpy().astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
