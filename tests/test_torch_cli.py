"""PyTorch port: the command line, ``python -m meshflow_tpu_torch.cli``,
on a small cv2-written clip on the CPU (``--device cpu``).

Checks the printout (finite metrics as one JSON line), the written video,
serving mode through ``--no-metrics`` and through MESHFLOW_COMPUTE_METRICS
when the flag is absent, and ``--visualize`` with ``--track-planes gray``:
the run shows each input frame above its output (``cv2.imshow`` and
``cv2.waitKey`` stubbed, Q pressed at the first frame) and writes the
video.
"""

import cv2
import numpy as np
import torch
from test_torch_threads import two_torch_threads  # noqa: F401  (autouse)


def _clip(num_frames, h, w, pan, seed=0):
    """Seeded BGR clip (tests/test_torch_slice.py): crops of a blurred
    noise canvas, a smooth pan plus +-3 px jitter."""
    rng = np.random.default_rng(seed)
    margin = 40
    small = rng.integers(0, 256, ((h + 2 * margin) // 4 + 1, (w + pan + 2 * margin) // 4 + 1, 3))
    canvas = np.repeat(np.repeat(small, 4, 0), 4, 1).astype(np.float32)
    canvas = np.round(cv2.GaussianBlur(canvas, (5, 5), 1.0)).astype(np.uint8)
    frames = []
    for t in range(num_frames):
        jx, jy = rng.integers(-3, 4, 2)
        x0 = margin + int(round(pan * t / max(num_frames - 1, 1))) + jx
        frames.append(canvas[margin + jy : margin + jy + h, x0 : x0 + w])
    return np.stack(frames)


def test_cli_smoke(tmp_path, capsys, monkeypatch):
    import json

    from meshflow_tpu_torch import cli

    frames = _clip(6, 180, 320, pan=6, seed=2)
    src = str(tmp_path / "in.avi")
    writer = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"MJPG"), 24.0, (320, 180))
    for f in frames:
        writer.write(f)
    writer.release()
    out = str(tmp_path / "out.avi")
    tiny = ["--mesh-rows", "8", "--mesh-cols", "8", "--subframe-rows", "2",
            "--subframe-cols", "2", "--device", "cpu", "--json"]
    assert cli.main([src, out, "--variant", "flipped", *tiny]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(np.isfinite(printed[k]) for k in ("cropping_ratio", "distortion_score",
                                                 "stability_score"))
    cap = cv2.VideoCapture(out)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(frames)
    cap.release()
    # serving mode: the flag, and the environment when the flag is absent
    for argv, env in ((["--no-metrics"], None), ([], "0")):
        if env is None:
            monkeypatch.delenv("MESHFLOW_COMPUTE_METRICS", raising=False)
        else:
            monkeypatch.setenv("MESHFLOW_COMPUTE_METRICS", env)
        assert cli.main([src, out, *argv, *tiny]) == 0
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isnan(printed["cropping_ratio"]) and np.isnan(printed["distortion_score"])
        assert np.isfinite(printed["stability_score"])
    shown, waits = [], []
    monkeypatch.setattr(cv2, "imshow", lambda name, img: shown.append((name, img)))
    monkeypatch.setattr(cv2, "waitKey", lambda ms: waits.append(ms) or ord("q"))
    out_gray = str(tmp_path / "out_gray.avi")
    assert cli.main([src, out_gray, "--visualize", "--track-planes", "gray", *tiny]) == 0
    assert waits == [int(1000 / 24.0)]
    (name, img), = shown
    assert name == "unstabilized and stabilized video" and img.shape == (360, 320, 3)
    cap = cv2.VideoCapture(out_gray)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == len(frames)
    cap.release()
