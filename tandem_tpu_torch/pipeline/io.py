"""Result writers matching the reference's output formats.

A copy of ``tandem_tpu/pipeline/io.py`` (numpy only).

Parity targets (tandem/src/FullSystem/FullSystem.cpp):
- result.txt  — TUM format "time tx ty tz qx qy qz qw" per frame (:300-322)
- poses_dso.txt — "id m00 m01 ... m33" flattened 4x4 per frame (:339-357)
- keyframes_dso.txt — same format, keyframes only (:359-382)
- dso_optimization_windows.txt — per-KF window tuples with scale (:388-404)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Return (qx, qy, qz, qw)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return np.array([qx, qy, qz, qw])


def write_result_tum(path: str, timestamps: Sequence[float],
                     poses_c2w: Sequence[np.ndarray]):
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses_c2w):
            t = T[:3, 3]
            q = rotation_to_quaternion(T[:3, :3])
            f.write(f"{ts:.9f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}\n")


def write_poses_mat(path: str, frame_ids: Sequence[int],
                    poses_c2w: Sequence[np.ndarray]):
    with open(path, "w") as f:
        for fid, T in zip(frame_ids, poses_c2w):
            vals = " ".join(f"{v:.9f}" for v in np.asarray(T).reshape(-1))
            f.write(f"{fid} {vals}\n")


def write_optimization_windows(path: str, windows: Sequence[Sequence[int]],
                               scales: Sequence[float] = None):
    with open(path, "w") as f:
        for i, win in enumerate(windows):
            line = f"{len(win)} " + " ".join(str(x) for x in win)
            if scales is not None:
                line += f" {scales[i]:.9f}"
            f.write(line + "\n")
