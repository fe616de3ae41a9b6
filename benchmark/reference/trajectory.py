"""The tracked trajectory against the scene's exact poses, in plain NumPy
(float64): a similarity alignment (monocular SLAM fixes no scale) and the
relative pose error between consecutive frames."""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np


def align_sim3(est: np.ndarray, gt: np.ndarray):
    """Umeyama's least-squares similarity: (s, R, t) with
    gt ~ s R est + t, for (N, 3) positions."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    de, dg = est - mu_e, gt - mu_g
    cov = dg.T @ de / len(est)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    var_e = (de * de).sum() / len(est)
    s = float(np.trace(np.diag(S) @ D) / var_e)
    return s, R, mu_g - s * R @ mu_e


def _angle_deg(R: np.ndarray) -> float:
    c = (np.trace(R) - 1.0) / 2.0
    return math.degrees(math.acos(max(-1.0, min(1.0, c))))


def trajectory_errors(est_c2w: Sequence[np.ndarray],
                      gt_c2w: Sequence[np.ndarray]) -> Dict[str, float]:
    """For consecutive frames i, i + 1: the relative motion's translation
    error (in the camera's frame, the estimate scaled by the similarity
    alignment of the whole trajectory) in mm, and its rotation error in
    degrees; the root mean square of each over the pairs
    (``rpe_mm``, ``rpe_deg``) and their medians, and the aligned
    positions' RMS error (``ate_mm``)."""
    est = [np.asarray(p, np.float64) for p in est_c2w]
    gt = [np.asarray(p, np.float64) for p in gt_c2w]
    if len(est) < 3:
        return {}
    pe = np.stack([p[:3, 3] for p in est])
    pg = np.stack([p[:3, 3] for p in gt])
    s, R, t = align_sim3(pe, pg)
    ate = np.sqrt(np.mean(np.sum((s * pe @ R.T + t - pg) ** 2, -1)))
    dt, dr = [], []
    for i in range(len(est) - 1):
        re = np.linalg.inv(est[i]) @ est[i + 1]
        rg = np.linalg.inv(gt[i]) @ gt[i + 1]
        dt.append(np.linalg.norm(s * re[:3, 3] - rg[:3, 3]))
        dr.append(_angle_deg(re[:3, :3].T @ rg[:3, :3]))
    return {"rpe_mm": 1e3 * float(np.sqrt(np.mean(np.square(dt)))),
            "rpe_deg": float(np.sqrt(np.mean(np.square(dr)))),
            "rpe_median_mm": 1e3 * float(np.median(dt)),
            "rpe_median_deg": float(np.median(dr)),
            "ate_mm": 1e3 * float(ate)}
