"""Trajectory evaluation: ATE with Horn (rigid or Sim3) alignment.

A copy of the ATE half of ``tandem_tpu/eval/ate.py`` (numpy only), the
Python-3 form of the TUM RGB-D tools the reference vendors
(tandem/tum_rgbd_eval_tools/: associate.py, evaluate_ate.py with the Horn
closed-form alignment :48-60, align_se3.py with the scale). The RPE half is
not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def associate(first: Dict[float, np.ndarray], second: Dict[float, np.ndarray],
              offset: float = 0.0, max_difference: float = 0.02
              ) -> List[Tuple[float, float]]:
    """Greedy timestamp matching (associate.py semantics)."""
    first_keys = sorted(first.keys())
    second_keys = sorted(second.keys())
    potential = [(abs(a - (b + offset)), a, b)
                 for a in first_keys for b in second_keys
                 if abs(a - (b + offset)) < max_difference]
    potential.sort()
    matches = []
    used_a, used_b = set(), set()
    for _, a, b in potential:
        if a not in used_a and b not in used_b:
            used_a.add(a)
            used_b.add(b)
            matches.append((a, b))
    matches.sort()
    return matches


def align_horn(model: np.ndarray, data: np.ndarray,
               with_scale: bool = False):
    """Closed-form rigid (or similarity) alignment of 3xN point sets:
    returns (R, t, s) minimizing ||s R model + t - data||
    (evaluate_ate.py:48-60, Horn 1987; align_se3.py adds the scale)."""
    mu_m = model.mean(axis=1, keepdims=True)
    mu_d = data.mean(axis=1, keepdims=True)
    mc = model - mu_m
    dc = data - mu_d
    U, S, Vt = np.linalg.svd(mc @ dc.T)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = Vt.T @ D @ U.T
    if with_scale:
        s = np.trace(np.diag(S) @ D) / np.maximum((mc * mc).sum(), 1e-12)
    else:
        s = 1.0
    return R, mu_d - s * (R @ mu_m), s


def align_sim3(model: np.ndarray, data: np.ndarray):
    return align_horn(model, data, with_scale=True)


def evaluate_ate(gt_xyz: np.ndarray, est_xyz: np.ndarray,
                 with_scale: bool = False) -> Dict[str, float]:
    """:param gt_xyz, est_xyz: (N, 3) associated positions
    :return: rmse/mean/median/std/min/max of the aligned errors, the scale
        and the number of pairs."""
    model = est_xyz.T
    data = gt_xyz.T
    R, t, s = align_horn(model, data, with_scale=with_scale)
    err = np.linalg.norm(s * (R @ model) + t - data, axis=0)
    return {
        "rmse": float(np.sqrt((err ** 2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "scale": float(s),
        "num_pairs": int(err.shape[0]),
    }


def load_tum_trajectory(path: str) -> Dict[float, np.ndarray]:
    """Read a TUM-format file -> {timestamp: (tx ty tz qx qy qz qw)}."""
    out = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            vals = [float(v) for v in line.split()]
            out[vals[0]] = np.array(vals[1:8])
    return out


def tum_to_xyz(traj: Dict[float, np.ndarray], keys) -> np.ndarray:
    return np.stack([traj[k][:3] for k in keys])
