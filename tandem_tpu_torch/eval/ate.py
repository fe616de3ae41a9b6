"""Trajectory evaluation: ATE with Horn (rigid or Sim3) alignment, RPE.

A copy of ``tandem_tpu/eval/ate.py`` (numpy only), the Python-3 form of
the TUM RGB-D tools the reference vendors (tandem/tum_rgbd_eval_tools/:
associate.py, evaluate_ate.py with the Horn closed-form alignment :48-60,
align_se3.py with the scale, evaluate_rpe.py).

``evaluate_rpe_stamped`` composes the relative error as the JAX package
does by default: rel = inv(T1) T0 of each trajectory and
err = inv(rel_est) rel_gt. With ``tum_order=True`` it takes TUM's order,
that of the RPE's definition in the TUM RGB-D benchmark paper (Sturm et
al., IROS 2012): rel = inv(T0) T1 and err = inv(rel_gt) rel_est. The rotation error is
the same in both; the translation error differs wherever the rotation
error is not zero.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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


def _pose_distance(T: np.ndarray) -> Tuple[float, float]:
    trans = float(np.linalg.norm(T[:3, 3]))
    angle = float(np.arccos(np.clip((np.trace(T[:3, :3]) - 1) / 2, -1, 1)))
    return trans, angle


def evaluate_rpe(gt_poses: Sequence[np.ndarray],
                 est_poses: Sequence[np.ndarray],
                 delta: int = 1) -> Dict[str, float]:
    """Relative pose error over frame pairs (i, i+delta)
    (evaluate_rpe.py semantics, fixed delta in frames)."""
    terrs, rerrs = [], []
    n = min(len(gt_poses), len(est_poses))
    for i in range(n - delta):
        gt_rel = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        est_rel = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        te, re = _pose_distance(np.linalg.inv(gt_rel) @ est_rel)
        terrs.append(te)
        rerrs.append(re)
    terrs = np.array(terrs)
    rerrs = np.array(rerrs)
    return {
        "trans_rmse": float(np.sqrt((terrs ** 2).mean())),
        "trans_mean": float(terrs.mean()),
        "rot_rmse": float(np.sqrt((rerrs ** 2).mean())),
        "rot_mean": float(rerrs.mean()),
        "num_pairs": int(len(terrs)),
    }


def _pose44(vals: np.ndarray) -> np.ndarray:
    """(tx ty tz qx qy qz qw) -> 4x4 (TUM quaternion convention)."""
    t = vals[:3]
    q = np.asarray(vals[3:7], np.float64)
    nq = float(q @ q)
    T = np.eye(4)
    if nq >= np.finfo(float).eps * 4.0:
        q = q * np.sqrt(2.0 / nq)
        Q = np.outer(q, q)
        T[:3, :3] = [
            [1.0 - Q[1, 1] - Q[2, 2], Q[0, 1] - Q[2, 3], Q[0, 2] + Q[1, 3]],
            [Q[0, 1] + Q[2, 3], 1.0 - Q[0, 0] - Q[2, 2], Q[1, 2] - Q[0, 3]],
            [Q[0, 2] - Q[1, 3], Q[1, 2] + Q[0, 3], 1.0 - Q[0, 0] - Q[1, 1]],
        ]
    T[:3, 3] = t
    return T


def _closest_index(sorted_vals: Sequence[float], t: float) -> int:
    i = int(np.searchsorted(np.asarray(sorted_vals), t))
    best, diff = 0, abs(sorted_vals[0] - t)
    for j in (i - 1, i):
        if 0 <= j < len(sorted_vals) and abs(sorted_vals[j] - t) < diff:
            best, diff = j, abs(sorted_vals[j] - t)
    return best


def _motion_accumulated(poses: Sequence[np.ndarray], measure) -> List[float]:
    """Cumulative per-step motion magnitude along a pose sequence."""
    acc, total = [0.0], 0.0
    for a, b in zip(poses[1:], poses[:-1]):
        total += measure(np.linalg.inv(a) @ b)
        acc.append(total)
    return acc


def evaluate_rpe_stamped(traj_gt: Dict[float, np.ndarray],
                         traj_est: Dict[float, np.ndarray],
                         max_pairs: int = 10000,
                         fixed_delta: bool = False,
                         delta: float = 1.0,
                         delta_unit: str = "s",
                         offset: float = 0.0,
                         scale: float = 1.0,
                         rng: np.random.RandomState | None = None,
                         tum_order: bool = False) -> List[List[float]]:
    """evaluate_rpe.py's evaluate_trajectory (:207-306) on stamped 4x4-pose
    trajectories: pair spacing in seconds ('s'), metres ('m'), radians
    ('rad'), degrees ('deg') or frames ('f'); without ``fixed_delta`` all
    pairs (randomly subsampled to ``max_pairs`` on a long trajectory), with
    it each i paired with the closest index delta away, then subsampled.
    Pairs whose nearest ground-truth stamps lie further than 2x the median
    GT interval are dropped. ``tum_order`` selects the composition (module
    docstring). Returns rows
    [stamp_est0, stamp_est1, stamp_gt0, stamp_gt1, trans_err, rot_err].
    """
    rng = rng or np.random.RandomState(0)
    stamps_gt = sorted(traj_gt.keys())
    stamps_est = sorted(traj_est.keys())
    n = len(stamps_est)
    if n < 2 or len(stamps_gt) < 2:
        raise ValueError("Trajectories overlap in fewer than two stamps.")

    est_poses = [np.asarray(traj_est[t], np.float64) for t in stamps_est]
    if delta_unit == "s":
        index_est: Sequence[float] = stamps_est
    elif delta_unit == "m":
        index_est = _motion_accumulated(
            est_poses, lambda T: float(np.linalg.norm(T[:3, 3])))
    elif delta_unit in ("rad", "deg"):
        k = 1.0 if delta_unit == "rad" else 180.0 / np.pi
        index_est = _motion_accumulated(
            est_poses, lambda T: k * _pose_distance(T)[1])
    elif delta_unit == "f":
        index_est = list(range(n))
    else:
        raise ValueError(f"Unknown delta unit {delta_unit!r}")

    if not fixed_delta:
        if max_pairs == 0 or n < np.sqrt(max_pairs):
            pairs = [(i, j) for i in range(n) for j in range(n)]
        else:
            pairs = [(int(rng.randint(0, n)), int(rng.randint(0, n)))
                     for _ in range(max_pairs)]
    else:
        pairs = []
        for i in range(n):
            j = _closest_index(index_est, index_est[i] + delta)
            if j != n - 1:
                pairs.append((i, j))
        if max_pairs != 0 and len(pairs) > max_pairs:
            keep = rng.choice(len(pairs), size=max_pairs, replace=False)
            pairs = [pairs[k] for k in sorted(keep)]

    gt_interval = float(np.median(np.diff(np.asarray(stamps_gt))))
    max_gt_gap = 2.0 * gt_interval

    def relative(a, b):           # the motion from pose a to pose b
        return (np.linalg.inv(a) @ b) if tum_order else (np.linalg.inv(b) @ a)

    rows = []
    for i, j in pairs:
        s_e0, s_e1 = stamps_est[i], stamps_est[j]
        s_g0 = stamps_gt[_closest_index(stamps_gt, s_e0 + offset)]
        s_g1 = stamps_gt[_closest_index(stamps_gt, s_e1 + offset)]
        if (abs(s_g0 - (s_e0 + offset)) > max_gt_gap
                or abs(s_g1 - (s_e1 + offset)) > max_gt_gap):
            continue
        rel_est = relative(traj_est[s_e0], traj_est[s_e1]).copy()
        rel_est[:3, 3] *= scale
        rel_gt = relative(traj_gt[s_g0], traj_gt[s_g1])
        err44 = (np.linalg.inv(rel_gt) @ rel_est if tum_order
                 else np.linalg.inv(rel_est) @ rel_gt)
        te, re = _pose_distance(err44)
        rows.append([s_e0, s_e1, s_g0, s_g1, te, re])
    if len(rows) < 2:
        raise ValueError(
            "No matching timestamp pairs between ground truth and estimate.")
    return rows


def rpe_stats(rows: Sequence[Sequence[float]]) -> Dict[str, float]:
    """Summary statistics over evaluate_rpe_stamped rows (verbose print
    block of the reference tool, trans in meters / rot in radians)."""
    te = np.asarray([r[4] for r in rows])
    re = np.asarray([r[5] for r in rows])
    return {
        "trans_rmse": float(np.sqrt((te ** 2).mean())),
        "trans_mean": float(te.mean()),
        "trans_median": float(np.median(te)),
        "trans_std": float(te.std()),
        "trans_min": float(te.min()),
        "trans_max": float(te.max()),
        "rot_rmse": float(np.sqrt((re ** 2).mean())),
        "rot_mean": float(re.mean()),
        "rot_median": float(np.median(re)),
        "num_pairs": int(len(rows)),
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
