"""DSO debug observability: logs/*.txt dumps + per-frame depth PNGs.

Parity targets:
- ``setting_logStuff`` log files (reference FullSystem.cpp:78-121 opens
  calibLog/numsLog/coarseTrackingLog/eigenAllLog/eigenPLog/eigenALog/
  diagonal/variancesLog/nullspacesLog; written by printLogLine
  :1664-1706, printEigenValLine :1709-1781, trackNewCoarse :635-643,
  printFrameLifetimes :1787-).
- ``debugSaveDepthImages`` per-keyframe/per-frame u16 depth PNGs + scale
  sidecars (settings.h:219-222; CoarseTracker::saveKFDepthMap
  CoarseTracker.cpp:1073-1135 / saveNKFDepthMap :1136-1215).

Port of ``tandem_tpu/utils/dso_log.py``: the same files, names, columns
and number formats; the depth PNGs are written by ``data/replica.write_png``
(the card's machine has no OpenCV).

Formats match the reference line-for-line where this rebuild has the same
quantity; counters this design has no analogue for (resInL/resInM —
there is no separate "linearized residual" class here, the FEJ prior
absorbs marginalized energy) are written as 0 so column positions stay
diffable. The eigen logs consume the Schur-reduced window system from
``tracking.ba.ba_log_system`` (DSO's lastHS/lastbS) in the same
CPARS-first column layout.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..data.replica import write_png


def _fmt(vec) -> str:
    return " ".join(f"{float(v):.10g}" for v in np.asarray(vec).ravel())


class DsoLogger:
    """Writes the reference's logs/*.txt debug files.

    Mirrors FullSystem's ofstream bundle: one file per quantity, a line per
    keyframe (or per tracked frame for coarseTrackingLog), flushed eagerly
    so a crashed run still leaves usable logs.
    """

    _EIGEN_FILES = ("eigenAllLog.txt", "eigenPLog.txt", "eigenALog.txt",
                    "diagonal.txt", "variancesLog.txt", "nullspacesLog.txt")

    def __init__(self, log_dir: str, max_frames: int = 7):
        os.makedirs(log_dir, exist_ok=True)
        self.dir = log_dir
        # nz padding: std::max(100, setting_maxFrames * 10)
        self.nz = max(100, max_frames * 10)
        names = ("calibLog.txt", "numsLog.txt",
                 "coarseTrackingLog.txt") + self._EIGEN_FILES
        self._f = {n: open(os.path.join(log_dir, n), "w") for n in names}
        # lifetimeLog is written once at close (printFrameLifetimes).

    # -- per tracked frame (trackNewCoarse, FullSystem.cpp:635-643) -------
    def log_coarse_tracking(self, frame_id: int, timestamp: float,
                            exposure: float, xi_c2w, a: float, b: float,
                            achieved_res: float, try_iterations: int):
        """:param xi_c2w: 6-vector se3 log of the frame's camToWorld."""
        f = self._f["coarseTrackingLog.txt"]
        f.write(f"{frame_id} {timestamp:.16g} {exposure:.16g} "
                f"{_fmt(xi_c2w)} {a:.16g} {b:.16g} {achieved_res:.10g} "
                f"{try_iterations}\n")
        f.flush()

    # -- per keyframe ------------------------------------------------------
    def log_nums(self, kf_id: int, rmse: float, n_created: int,
                 n_activated: int, n_dropped: int, n_opt_its: int,
                 res_in_a: int, aff_a: float, aff_b: float,
                 window_span: int, window_size: int):
        """numsLog.txt, FullSystem.cpp:1684-1703. resInL/resInM and the
        marg/forceDrop counters are structurally 0 in this rebuild (the FEJ
        prior replaces DSO's linearized-residual bookkeeping)."""
        f = self._f["numsLog.txt"]
        f.write(f"{kf_id} {rmse:.10g} {n_created} {n_activated} {n_dropped} "
                f"{n_opt_its} {res_in_a} 0 0 0 0 0 0 "
                f"{aff_a:.10g} {aff_b:.10g} {window_span} {window_size} \n")
        f.flush()

    def log_eigenvalues(self, kf_id: int, H: np.ndarray, b: np.ndarray,
                        nullspaces: np.ndarray, n_frames: int):
        """printEigenValLine (FullSystem.cpp:1709-1781) on the Schur-reduced
        system. ``H``/``b`` use DSO's CPARS-first layout; only the first
        ``4 + 8*n_frames`` rows/cols are live (the rest are empty slots)."""
        CPARS = 4
        P = CPARS + 8 * n_frames
        H = np.asarray(H, np.float64)[:P, :P]
        b = np.asarray(b, np.float64)[:P]
        n = n_frames
        # Pose (6) / affine (2) sub-blocks of the frame part
        idx_p = np.concatenate([CPARS + i * 8 + np.arange(6)
                                for i in range(n)]) if n else np.zeros(0, int)
        idx_a = np.concatenate([CPARS + i * 8 + 6 + np.arange(2)
                                for i in range(n)]) if n else np.zeros(0, int)
        Hp = H[np.ix_(idx_p, idx_p)]
        Ha = H[np.ix_(idx_a, idx_a)]

        def pad_sorted(vals):
            out = np.zeros(self.nz)
            v = np.sort(np.real(vals))
            out[:len(v)] = v[:self.nz]
            return out

        eig_all = pad_sorted(np.linalg.eigvals(H))
        eig_p = pad_sorted(np.linalg.eigvals(Hp)) if len(idx_p) \
            else np.zeros(self.nz)
        eig_a = pad_sorted(np.linalg.eigvals(Ha)) if len(idx_a) \
            else np.zeros(self.nz)
        diag = np.zeros(self.nz)
        diag[:P] = np.diag(H)[:self.nz]
        var = np.zeros(self.nz)
        try:
            var[:P] = np.diag(np.linalg.inv(H))[:self.nz]
        except np.linalg.LinAlgError:
            pass

        for name, vec in (("eigenAllLog.txt", eig_all),
                          ("eigenPLog.txt", eig_p),
                          ("eigenALog.txt", eig_a),
                          ("diagonal.txt", diag),
                          ("variancesLog.txt", var)):
            f = self._f[name]
            f.write(f"{kf_id} {_fmt(vec)}\n")
            f.flush()

        ns = np.asarray(nullspaces, np.float64)[:P]
        f = self._f["nullspacesLog.txt"]
        f.write(f"{kf_id} ")
        for i in range(ns.shape[1]):
            col = ns[:, i]
            f.write(f"{col @ (H @ col):.10g} {col @ b:.10g} ")
        f.write("\n")
        f.flush()

    # -- end of run --------------------------------------------------------
    def log_lifetimes(self, frames: Sequence):
        """printFrameLifetimes: one line per frame —
        id marginalizedAt goodResOnThis outlierResOnThis movedByOpt
        (FullSystem.cpp:1787-1812). Frames are
        (id, marginalized_at, good, bad, moved_by_opt) tuples."""
        with open(os.path.join(self.dir, "lifetimeLog.txt"), "w") as f:
            for fid, marg_at, good, bad, moved in frames:
                f.write(f"{fid} {marg_at} {good} {bad} {moved:.15g}\n")

    def close(self):
        for f in self._f.values():
            f.close()


def save_depth_png(folder: str, frame_id: int, idepth: np.ndarray,
                   weight: Optional[np.ndarray] = None):
    """``debugSaveDepthImages`` dump: u16 PNG scaled so max depth = 65535
    plus a ``<id>_scale.txt`` sidecar holding metres-per-unit
    (CoarseTracker::saveKFDepthMap, CoarseTracker.cpp:1073-1135). The
    reference filters pixels by idepth variance <= 1e-5; this rebuild's
    tracker ref carries a support weight instead, used the same way
    (zero-weight pixels stay black)."""
    os.makedirs(folder, exist_ok=True)
    idepth = np.asarray(idepth, np.float32)
    ok = idepth > 0
    if weight is not None:
        ok &= np.asarray(weight) > 0
    depth = np.where(ok, 1.0 / np.maximum(idepth, 1e-12), 0.0)
    max_depth = float(depth.max())
    scaling = 65535.0 / max_depth if max_depth > 0 else 1.0
    img = np.where(ok, depth * scaling + 0.5, 0.0).astype(np.uint16)
    write_png(os.path.join(folder, f"{frame_id:06d}.png"), img)
    with open(os.path.join(folder, f"{frame_id:06d}_scale.txt"), "w") as f:
        f.write(f"{1.0 / scaling:.15g}")
