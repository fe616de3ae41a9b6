"""FullSystem: the per-frame tracking + mapping pipeline hub.

Port of ``tandem_tpu/pipeline/full_system.py`` (the reference's
tandem/src/FullSystem/FullSystem.{h,cpp}: addActiveFrame, the joint
initializer, tracking with the retry ladder, immature-point tracing, the
keyframe decision, windowed BA, marginalization, point insertion and
activation, and the TANDEM backend hookup deliverDrFrame,
FullSystem.cpp:1122-1198). Host-side orchestration in Python; every hot
step runs as torch ops on the window's device, the card unless the caller
asks for the CPU.

Capacities are semantics: the point and immature capacities are the
settings' densities rounded up to a multiple of 256 and the window has
max_keyframes + 1 slots, as in the JAX package; they decide which points
are kept and keep every shape static.

A frame costs one packed host read of the tracker's outputs (plus the
tracker's own reads of its LM state); a keyframe a few more, each one
packed tensor. Frames are uploaded as uint8 and cast on the device.

RGB-D mode (``rgbd`` with a sensor depth per frame, FullSystem.cpp's
rgbd_flag): the first frame is initialized from its depth (no
initializer), each frame is tracked by dvo-core's dense bivariate tracker
on pyramid level 1 (``tracking/dvo.py``, CoarseTracker::
trackNewestCoarseDense) and its DSO residual statistics are taken at that
pose (``calc_res_eval``, K6), with the Student-t ``track_frame`` as the
fallback; keyframes seed points and the tracking reference from their
depth. The dvo path adds no host read: its ``n`` shares the frame's read.

Observability (the JAX package's hooks, at the same places):
``log_stuff`` writes the reference's logs/*.txt (``utils/dso_log.py``: the
coarse-tracking line a frame, the nums and eigen lines a keyframe from
``tracking/ba.ba_log_system``, the lifetimes at ``write_results``);
``debug_save_depth_images`` dumps the projected BA depth of every tracked
non-keyframe and every new tracking reference; ``outputs`` (Output3DWrapper
sinks) get each pose and the keyframe list. Each costs host reads only
when it is on: with none of them a frame keeps its one packed read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.cva_mvsnet import pin_f32_precision
from ..core.se3 import se3_log
from ..tracking.ba import (BAState, _bilinear, ba_iterate, ba_log_system,
                           create_ba_state, marginalize_frame, pattern,
                           remove_outliers)
from ..tracking.coarse_tracker import (calc_res_eval, make_tracker_ref,
                                       rotation_perturbations,
                                       splat_depth_to_ref, track_frame,
                                       track_frame_multi)
from ..tracking.dvo import build_rgbd_pyramid, dense_match
from ..tracking.immature import (ImmaturePoints, activate_points,
                                 make_immature, trace_points)
from ..tracking.initializer import initializer_track, make_initializer
from ..tracking.point_selection import select_pixels
from ..utils.consts import const, upload
from ..utils.dso_log import DsoLogger, save_depth_png
from ..utils.timer import Timer
from .io import (write_optimization_windows, write_poses_mat,
                 write_result_tum)


def resolve_device(device) -> torch.device:
    """The card unless the caller names another device; asking for the
    card where there is none raises (there is no CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tandem_tpu_torch runs on an NVIDIA GPU by "
                           "default and none is available; pass "
                           "device='cpu' to run on the CPU")
    return dev


def reference_idepth_quantile(idepth: np.ndarray, fraction: float) -> float:
    """Exact get_idepth_quantile arithmetic (tandem_backend.cpp:354-361):
    the element at index int(fraction * n) of the idepths sorted ascending.
    The caller reciprocates it: fraction 0.2 selects a far point."""
    idv = np.asarray(idepth, dtype=np.float32)
    k = int(fraction * float(len(idv)))
    k = min(max(k, 0), len(idv) - 1)
    return float(np.partition(idv, k)[k])


def _np_rigid_inverse(T: np.ndarray) -> np.ndarray:
    R = T[:3, :3]
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ T[:3, 3]
    return out


def _nearest_rigid(T: np.ndarray) -> np.ndarray:
    """T with its rotation block replaced by the nearest rotation (the
    orthogonal factor of its polar decomposition, in float64), as DSO's
    Sophus SE3 keeps every pose.

    A tracked pose is ``ref_c2w @ _np_rigid_inverse(T)`` and the next
    frame's prediction uses general inverses (``_motion_model``). Composed
    without this projection, as the JAX package does, a rotation block's
    departure from SO(3) follows e' = 2 e_ref - 2 e_last + e_prev, whose
    largest root is -(1 + sqrt 2): a rounding-level difference grows about
    2.4x a frame with alternating sign until the tracker's basin breaks
    (PERF.md, "The trajectory fixture's sensitivity")."""
    out = np.asarray(T, np.float64).copy()
    U, _, Vt = np.linalg.svd(out[:3, :3])
    out[:3, :3] = U @ Vt
    return out.astype(np.float32)


def rodrigues_to_vector(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> axis-angle vector (3,), as cv2.Rodrigues computes
    it, angles near 0 and near pi included."""
    R = np.asarray(R, np.float64)
    rx, ry, rz = R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]
    s = np.sqrt((rx * rx + ry * ry + rz * rz) * 0.25)
    c = np.clip((R[0, 0] + R[1, 1] + R[2, 2] - 1) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros(3)
        # Near pi: the axis from the diagonal of (R + I) / 2.
        t = (R[0, 0] + 1) * 0.5
        rx = np.sqrt(max(t, 0.0))
        t = (R[1, 1] + 1) * 0.5
        ry = np.sqrt(max(t, 0.0)) * (-1.0 if R[0, 1] < 0 else 1.0)
        t = (R[2, 2] + 1) * 0.5
        rz = np.sqrt(max(t, 0.0)) * (-1.0 if R[0, 2] < 0 else 1.0)
        if (abs(rx) < abs(ry) and abs(rx) < abs(rz)
                and (R[1, 2] > 0) != (ry * rz > 0)):
            rz = -rz
        theta /= np.sqrt(rx * rx + ry * ry + rz * rz)
        return np.array([rx, ry, rz]) * theta
    vth = 1.0 / (2.0 * s) * theta
    return np.array([rx, ry, rz]) * vth


def rodrigues_to_matrix(rvec: np.ndarray) -> np.ndarray:
    """Axis-angle vector -> rotation matrix, as cv2.Rodrigues computes it."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = np.linalg.norm(r)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    c1 = 1.0 - c
    k = r / theta
    rrt = np.outer(k, k)
    r_x = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return c * np.eye(3) + c1 * rrt + s * r_x


@dataclasses.dataclass
class FullSystemOptions:
    max_keyframes: int = 7            # setting_maxFrames
    min_frames: int = 5               # setting_minFrames
    min_frame_age: int = 1            # setting_minFrameAge
    num_point_slots: int = 2048
    # Keyframe decision weights (FullSystem.cpp:1038-1058; settings.cpp:
    # 37-41): the reference's hardcoded 640+480 scale, divided by the
    # actual w+h in the decision.
    kf_global_weight: float = 1.0         # setting_kfGlobalWeight
    max_shift_weight_t: float = 0.04 * (640 + 480)
    max_shift_weight_r: float = 0.0 * (640 + 480)
    max_shift_weight_rt: float = 0.02 * (640 + 480)
    max_affine_weight: float = 2.0        # setting_maxAffineWeight
    keyframes_per_second: float = 0.0     # setting_keyframesPerSecond
    ba_iters: int = 6                 # setting_maxOptIterations
    immature_cap: int = 512
    selection_threshold_factor: float = 1.0
    init_min_good_frac: float = 0.5
    init_max_width: float = 0.25
    mvs_view_num: int = 7
    mvs_discard_percentage: float = 10.0  # setting_mvsnet_discard_percentage
    tracking_step: int = 3            # setting_tracking_step dense stride
    rgbd: bool = False                # RGB-D mode (rgbd_flag)
    dense_tracking: bool = True       # tracking=dense vs sparse
    # linearizeOperation (playbackSpeed == 0): a busy backend is waited
    # for; real-time mode drops the keyframe (FullSystem.cpp:1144-1151).
    linearize: bool = True
    # Debug observability (utils/dso_log.py).
    log_stuff: bool = False
    log_dir: str = "logs"
    debug_save_depth_images: bool = False
    depth_save_folder: str = "depths"


def make_full_system_options(s) -> FullSystemOptions:
    """Map runtime Settings onto FullSystemOptions; the density knobs become
    the fixed capacities, rounded up to a multiple of 256."""
    def cap(x):
        return -(-int(x) // 256) * 256

    return FullSystemOptions(
        max_keyframes=s.max_frames,
        min_frames=s.min_frames,
        min_frame_age=s.min_frame_age,
        num_point_slots=cap(s.desired_point_density),
        kf_global_weight=s.kf_global_weight,
        keyframes_per_second=s.keyframes_per_second,
        ba_iters=s.max_opt_iterations,
        immature_cap=cap(s.desired_immature_density),
        mvs_view_num=s.dr_mvsnet_view_num,
        mvs_discard_percentage=s.mvsnet_discard_percentage,
        tracking_step=s.tracking_step,
        rgbd=s.rgbd,
        dense_tracking=(s.tracking_type == "dense"),
        linearize=(s.playback_speed == 0),
        log_stuff=s.log_stuff,
        log_dir=os.path.join(s.result_folder, "logs"),
        debug_save_depth_images=s.debug_save_depth_images,
        depth_save_folder=(s.depth_save_folder
                           or os.path.join(s.result_folder, "depths")))


class Keyframe:
    def __init__(self, frame_id, timestamp, image, c2w):
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.image = image          # (H, W) float32 tensor on the device
        self.c2w = np.asarray(c2w)
        self.slot: Optional[int] = None
        self.kf_id: int = -1        # keyframe index (FrameHessian::frameID)
        self.immature: Optional[ImmaturePoints] = None
        self.n_immature: int = 0    # host count at creation
        self.n_points_total: int = 0  # BA points ever inserted for this KF
        self.bgr: Optional[np.ndarray] = None
        self.sensor_depth: Optional[np.ndarray] = None  # RGB-D mode
        self.sensor_depth_dev: Optional[torch.Tensor] = None
        self._c2w_src = self._c2w_dev = None

    def c2w_on(self, device) -> torch.Tensor:
        """c2w as a float32 tensor on ``device``, uploaded once a value
        (c2w is replaced, never changed in place)."""
        if self._c2w_src is not self.c2w:
            self._c2w_dev, self._c2w_src = upload(self.c2w, device), self.c2w
        return self._c2w_dev


def _fetch(*tensors) -> List[np.ndarray]:
    """One host read of several device tensors: they are packed into one
    float64 vector (exact for the float32 values, bools and the small
    integers read here) and split on the host."""
    flat = torch.cat([t.reshape(-1).double() for t in tensors]).cpu().numpy()
    out, pos = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[pos:pos + n].reshape(tuple(t.shape)))
        pos += n
    return out


class FullSystem:
    def __init__(self, fx, fy, cx, cy, height, width,
                 options: FullSystemOptions = None, backend=None,
                 timer: Timer = None, outputs=None, device=None):
        self.opt = options or FullSystemOptions()
        self.outputs = outputs or []  # Output3DWrapper sinks
        self.device = resolve_device(device)
        # BA's products must be true f32 (no TF32) and cuDNN deterministic;
        # a VO-only run builds no CvaMVSNet, which would otherwise pin it.
        pin_f32_precision()
        dev = self.device
        self.K = (float(fx), float(fy), float(cx), float(cy))
        self.K_mat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                              np.float32)
        self.H, self.W = height, width
        self.backend = backend
        self.timer = timer or Timer(enabled=False)

        F = self.opt.max_keyframes + 1
        self.ba_state = create_ba_state(F, self.opt.num_point_slots,
                                        device=dev)
        self.slot_images = torch.zeros((F, height, width), device=dev)
        self.kf_of_slot: List[Optional[Keyframe]] = [None] * F

        self.keyframes: List[Keyframe] = []
        self.all_poses: List[np.ndarray] = []   # per-frame c2w
        self.all_ids: List[int] = []
        self.all_ts: List[float] = []

        self.tracker_ref = None
        self._dvo_ref = None        # RGB-D: the reference's dvo pyramid
        self._current_depth = None  # RGB-D: this frame's depth (host, card)
        self.n_dvo_frames = 0       # frames the dvo branch tracked
        self.n_dvo_fallbacks = 0    # dvo frames that fell back to LM
        self.n_dvo_poses = 0        # frames whose pose is dvo's (no retry)
        self.ref_kf: Optional[Keyframe] = None
        self.last_c2w = np.eye(4, dtype=np.float32)
        self.prev_c2w = np.eye(4, dtype=np.float32)
        self.initialized = False
        self.is_lost = False
        self.init_failed = False
        self.init_frames = 0
        self.init_state = None
        self._last_energy: Optional[float] = None
        self._first_coarse_rmse: Optional[float] = None  # firstCoarseRMSE
        # lastCoarseRMSE (FullSystem.h:320, init 100): the previous frame's
        # achieved residual, the retry ladder's gate (FullSystem.cpp:605).
        self._last_coarse_rmse: float = 100.0
        self.n_dropped_kf = 0   # real-time mode backend drops
        self.n_retracks = 0     # retry ladder firings
        self.windows: List[List[int]] = []
        self._lifetimes: dict = {}
        # setting_logStuff observability (FullSystem.cpp:78-121) and the
        # cumulative statistics_* counters of printLogLine.
        self.logger = (DsoLogger(self.opt.log_dir, self.opt.max_keyframes)
                       if self.opt.log_stuff else None)
        self._stat_created = 0
        self._stat_activated = 0
        self._stat_dropped = 0

    def _tensor(self, x):
        return upload(x, self.device)

    # ------------------------------------------------------------------
    def add_active_frame(self, gray: np.ndarray, frame_id: int,
                         timestamp: float = None, bgr: np.ndarray = None,
                         depth: np.ndarray = None):
        """:param depth: optional (H, W) sensor depth in metres (RGB-D
        mode; 0 = invalid)."""
        timestamp = float(frame_id) if timestamp is None else timestamp
        # uint8 frames go up as uint8 and are cast on the device (no /255).
        if gray.dtype == np.uint8:
            img = upload(gray, self.device, np.uint8).float()
        else:
            img = self._tensor(gray)
        self._current_depth = None
        if depth is not None and self.opt.rgbd:
            depth = np.asarray(depth, np.float32)
            self._current_depth = (depth, self._tensor(depth))

        if not self.keyframes:
            if self.opt.rgbd and depth is not None:
                self._first_frame_rgbd(img, frame_id, timestamp, bgr)
            else:
                self._first_frame(img, frame_id, timestamp, bgr)
            return
        if not self.initialized:
            tid = self.timer.start_timing("initializer")
            self._initializer_step(img, frame_id, timestamp, bgr)
            self.timer.end_timing("initializer", tid)
            return

        tid = self.timer.start_timing("track_frame")
        T_init = self._motion_model()
        aff0 = const((1.0, 0.0), self.device)
        tdist = self.opt.rgbd
        # RGB-D: dvo-core's dense tracker on level 1, then the DSO residual
        # statistics at its pose (trackNewestCoarseDense, CoarseTracker.cpp:
        # 939-964); kept when the energy is finite and n >= 6.
        dvo_tracked = False
        if (self.opt.rgbd and depth is not None
                and self._dvo_ref is not None):
            self.n_dvo_frames += 1
            cur_pyr = build_rgbd_pyramid(img, self._current_depth[1],
                                         *self.K, num_levels=2)
            m = dense_match(self._dvo_ref, cur_pyr, self._tensor(T_init),
                            on_level=1)
            out = self._read_track(calc_res_eval(self.tracker_ref, img,
                                                 m["T"], aff0), m["n"])
            dvo_tracked = np.isfinite(out["energy"]) and out["extra"] >= 6
            self.n_dvo_fallbacks += not dvo_tracked
        if not dvo_tracked:
            out = self._read_track(track_frame(
                self.tracker_ref, img, self._tensor(T_init), aff0, tdist))
        energy = out["energy"]

        # The retry ladder (trackNewCoarse, FullSystem.cpp:449-529), gated
        # on setting_reTrackThreshold x lastCoarseRMSE (:605,617).
        bad = (not np.isfinite(energy) or out["valid_frac"] < 0.3
               or energy > 1.5 * self._last_coarse_rmse)
        if bad:
            self.n_retracks += 1
            t_retry = self.timer.start_timing("track_retry")
            # DSO's candidate order: const motion, double, half, zero
            # motion, at the KF; then the rotation perturbations.
            cands = [T_init]
            if len(self.all_poses) >= 2:
                rel = self.last_c2w @ _np_rigid_inverse(self.prev_c2w)
                rv = rodrigues_to_vector(rel[:3, :3].astype(np.float64))
                half = np.eye(4)
                half[:3, :3] = rodrigues_to_matrix(0.5 * rv)
                half[:3, 3] = 0.5 * rel[:3, 3]
                cands.append(np.linalg.inv(rel @ rel @ self.last_c2w)
                             @ np.asarray(self.ref_kf.c2w))      # double
                cands.append(np.linalg.inv(half @ self.last_c2w)
                             @ np.asarray(self.ref_kf.c2w))      # half
            cands.append(np.linalg.inv(self.last_c2w)
                         @ np.asarray(self.ref_kf.c2w))          # zero motion
            cands.append(np.eye(4))                              # at the KF
            out = self._read_track(track_frame_multi(
                self.tracker_ref, img, self._tensor(np.stack(cands)), aff0,
                tdist))
            energy = out["energy"]
            if (not np.isfinite(energy) or out["valid_frac"] < 0.3
                    or energy > 1.5 * self._last_coarse_rmse):
                perts = rotation_perturbations()
                out2 = self._read_track(track_frame_multi(
                    self.tracker_ref, img,
                    self._tensor(np.einsum("nij,jk->nik", perts, T_init)),
                    aff0, tdist))
                e2 = out2["energy"]
                if np.isfinite(e2) and (not np.isfinite(energy)
                                        or e2 < energy):
                    out, energy = out2, e2
            self.timer.end_timing("track_retry", t_retry)
        self.timer.end_timing("track_frame", tid)

        if (not np.isfinite(energy) or out["valid_frac"] <= 0.0
                or out["num_terms"] < 16):
            # "BIG ERROR! tracking failed entirely" (FullSystem.cpp:610-615)
            self.is_lost = True
            return
        if dvo_tracked and not bad:
            self.n_dvo_poses += 1
        self._last_energy = energy
        self._last_coarse_rmse = energy   # lastCoarseRMSE = achievedRes
        c2w = _nearest_rigid(self.ref_kf.c2w @ _np_rigid_inverse(out["T"]))
        self._record_pose(frame_id, timestamp, c2w)

        # Tracing runs on every frame (traceNewCoarse, FullSystem.cpp:1295).
        t_trace = self.timer.start_timing("trace")
        self._trace_on_frame(img, c2w)
        self.timer.end_timing("trace", t_trace)

        if self._first_coarse_rmse is None:
            self._first_coarse_rmse = energy
        need_kf = self._keyframe_decision(out["flow"], out, energy, timestamp)
        if self.logger is not None:
            # trackNewCoarse logging (FullSystem.cpp:635-643): id, ts,
            # exposure, camToWorld.log(), aff a/b, achieved residual, tries.
            xi = se3_log(torch.from_numpy(c2w.astype(np.float32))).numpy()
            self.logger.log_coarse_tracking(
                frame_id, timestamp, 1.0, xi, float(out["aff"][0]),
                float(out["aff"][1]), energy, 2 if bad else 1)
        if self.opt.debug_save_depth_images and not need_kf:
            # saveNKFDepthMap (CoarseTracker.cpp:1136-1215, from
            # makeNonKeyFrame FullSystem.cpp:1281): the active points
            # projected into the newly tracked frame.
            idep, wgt = _fetch(*_project_ba_points(
                self.ba_state, self._tensor(c2w), self.K, self.H, self.W))
            save_depth_png(self.opt.depth_save_folder, frame_id, idep, wgt)
        if need_kf:
            self._make_keyframe(img, frame_id, timestamp, c2w, bgr)

    @staticmethod
    def _read_track(out: dict, extra=None) -> dict:
        """The tracker's outputs in one host read: T as float32 (4, 4),
        aff (2,), flow (3,) and the scalars as floats; ``extra`` (a 0-dim
        tensor) joins the read as ``out["extra"]``."""
        more = () if extra is None else (extra,)
        T, aff, e, n, vf, flow, *rest = _fetch(
            out["T"], out["aff"], out["energy"], out["num_terms"],
            out["valid_frac"], out["flow"], *more)
        return {"T": T.astype(np.float32), "aff": aff, "energy": float(e),
                "num_terms": float(n), "valid_frac": float(vf),
                "flow": flow, "extra": float(rest[0]) if rest else None}

    def _select_uv(self, img) -> Tuple[np.ndarray, int]:
        """Gradient-based candidate selection with DSO-style density
        adaptation (PixelSelector2::makeMaps): the counts of every
        (factor, potential) the adaptation can visit in one host read, the
        loop on the host, then the chosen pixels extracted on the device
        (a second read)."""
        want = self.opt.immature_cap
        f0 = float(self.opt.selection_threshold_factor)
        ladder = [(f0, 4), (f0, 8), (f0, 2), (f0, 1), (f0 * 0.4, 1)]
        counts = {cfg: int(n) for cfg, n in zip(
            ladder, _fetch(_select_counts(img, f0))[0])}
        factor, potential = f0, 4
        final = (factor, potential)
        for _ in range(4):
            n = counts[(factor, potential)]
            final = (factor, potential)
            if n > 4 * want and potential < 8:
                potential *= 2
            elif n < want // 4 and potential > 1:
                potential //= 2
            elif n < want // 4:
                factor *= 0.4
            else:
                break
        uv, n = _select_uv_device(img, final[0], final[1], want)
        return uv, n

    # ------------------------------------------------------------------
    def _first_frame_rgbd(self, img, frame_id, timestamp, bgr):
        """RGB-D initialization: the sensor depth gives metric structure at
        frame 0 (CoarseRGBDInitializer, FullSystem.cpp:1000-1013)."""
        kf = Keyframe(frame_id, timestamp, img, np.eye(4, dtype=np.float32))
        kf.bgr = bgr
        kf.kf_id = 0
        kf.sensor_depth, kf.sensor_depth_dev = self._current_depth
        self.keyframes.append(kf)
        self.ref_kf = kf
        self._record_pose(frame_id, timestamp, kf.c2w)
        self._assign_slot(kf)

        uv, n_sel = self._select_uv(img)
        d = kf.sensor_depth[uv[:, 1].astype(int), uv[:, 0].astype(int)]
        self._insert_points(kf, uv, 1.0 / np.maximum(d, 0.05), d > 0.05)

        depth = kf.sensor_depth_dev
        valid = depth > 0.05
        idepth0 = torch.where(valid, 1.0 / torch.clamp(depth, min=0.05),
                              torch.zeros_like(depth))
        self.tracker_ref = make_tracker_ref(
            img, *self.K, sparse_idepth=idepth0, sparse_weight=valid.float())
        self._dvo_ref = build_rgbd_pyramid(img, depth, *self.K, num_levels=2)
        kf.immature = make_immature(self._tensor(uv), img)
        kf.n_immature = min(n_sel, self.opt.immature_cap)
        self.initialized = True

    def _first_frame(self, img, frame_id, timestamp, bgr):
        kf = Keyframe(frame_id, timestamp, img, np.eye(4, dtype=np.float32))
        kf.bgr = bgr
        kf.kf_id = 0
        self.keyframes.append(kf)
        self.ref_kf = kf
        self._record_pose(frame_id, timestamp, kf.c2w)
        self.init_state = make_initializer(img, *self.K)

    def _initializer_step(self, img, frame_id, timestamp, bgr):
        """Joint multi-level LM until snapped and stable for 5 frames
        (CoarseInitializer::trackFrame, initializeFromInitializer,
        FullSystem.cpp:1436-1525)."""
        kf = self.keyframes[0]
        self.init_frames += 1
        self.init_state, done = initializer_track(
            self.init_state, img, *self.K, (self.H, self.W))
        st = self.init_state

        iR0, good0, valid0, T, done_np = _fetch(
            st.iR[0], st.is_good[0], st.pvalid[0], st.T, done)
        use = (good0 != 0) & (valid0 != 0)
        iR0 = iR0.astype(np.float32)
        mean_iR = float(iR0[use].mean()) if use.any() else 1.0
        rescale = 1.0 / max(mean_iR, 1e-5)
        T_scaled = T.astype(np.float32).copy()
        T_scaled[:3, 3] /= rescale
        c2w = kf.c2w @ _np_rigid_inverse(T_scaled)
        self._record_pose(frame_id, timestamp, c2w)

        if bool(done_np):
            # initializeFromInitializer: idepth = iR * rescale, the level-0
            # points become active BA points.
            pu, pv = _fetch(st.pu[0], st.pv[0])
            uv = np.stack([pu, pv], -1).astype(np.float32)
            idep = iR0 * rescale
            ok = use & (idep > 1e-4)
            cap = self.ba_state.pt_uv.shape[0] // 2
            if int(ok.sum()) > cap:
                ranks = np.cumsum(ok) - 1
                ok = ok & (ranks % max(int(ok.sum()) // cap + 1, 1) == 0)
            self._assign_slot(kf)
            self._insert_points(kf, uv, idep.astype(np.float32), ok)
            self._make_keyframe(img, frame_id, timestamp, c2w, bgr,
                                from_init=True)
            self.initialized = True
            return

        if self.init_frames > 40:
            # initFailed: the caller resets (FullSystem.cpp:1351-1364).
            self.init_failed = True

    # ------------------------------------------------------------------
    def _motion_model(self) -> np.ndarray:
        """Constant-velocity prediction as T_ref->new (w2c_new @ c2w_ref)."""
        if len(self.all_poses) < 2:
            pred_c2w = self.last_c2w
        else:
            pred_c2w = self.last_c2w @ np.linalg.inv(self.prev_c2w) \
                @ self.last_c2w
        return (np.linalg.inv(pred_c2w) @ self.ref_kf.c2w).astype(np.float32)

    def _record_pose(self, frame_id, timestamp, c2w):
        self._lifetimes.setdefault(frame_id, [frame_id, 0.0])
        self.prev_c2w = self.last_c2w
        self.last_c2w = np.asarray(c2w, np.float32)
        self.all_poses.append(self.last_c2w.copy())
        self.all_ids.append(frame_id)
        self.all_ts.append(timestamp)
        for ow in self.outputs:
            ow.publish_cam_pose(frame_id, self.last_c2w)

    def _keyframe_decision(self, flow, out, energy: float,
                           timestamp: float) -> bool:
        """The reference's keyframe rule (FullSystem.cpp:1038-1058)."""
        o = self.opt
        if o.keyframes_per_second > 0:
            last_kf_ts = self.keyframes[-1].timestamp
            return bool(timestamp - last_kf_ts > 0.95 / o.keyframes_per_second)
        tres1, tres2, tres3 = (float(x) for x in flow)
        a = float(np.asarray(out["aff"])[0])
        wh = self.W + self.H
        score = o.kf_global_weight * (
            o.max_shift_weight_t * np.sqrt(max(tres1, 0.0)) / wh
            + o.max_shift_weight_r * np.sqrt(max(tres2, 0.0)) / wh
            + o.max_shift_weight_rt * np.sqrt(max(tres3, 0.0)) / wh
            + o.max_affine_weight * abs(np.log(max(a, 1e-12))))
        first = self._first_coarse_rmse
        return bool(score > 1.0
                    or (first is not None and 2.0 * first < energy))

    def _assign_slot(self, kf: Keyframe):
        # kf_of_slot mirrors frame_valid exactly: no device read.
        free = [i for i, k in enumerate(self.kf_of_slot) if k is None]
        if not free:
            self._marginalize_oldest()
            free = [i for i, k in enumerate(self.kf_of_slot) if k is None]
        slot = int(free[0])
        kf.slot = slot
        self.kf_of_slot[slot] = kf
        self.ba_state, self.slot_images = _assign_slot_state(
            self.ba_state, self.slot_images, slot,
            kf.c2w_on(self.device), kf.image)

    def _marginalize_oldest(self):
        active = [kf for kf in self.keyframes if kf.slot is not None]
        active.sort(key=lambda k: k.frame_id)
        self._marginalize_kf(active[0])

    def _marginalize_kf(self, victim: Keyframe):
        if victim.frame_id in self._lifetimes:
            self._lifetimes[victim.frame_id][0] = \
                self.keyframes[-1].frame_id
        self.ba_state = marginalize_frame(
            self.ba_state, self.slot_images, self.K, victim.slot)
        self.kf_of_slot[victim.slot] = None
        victim.slot = None

    def _flag_frames_for_marginalization(self) -> List[Keyframe]:
        """DSO's frame-selection policy (flagFramesForMarginalization,
        FullSystemMarginalize.cpp:56-119), evaluated before the new keyframe
        joins the window: (a) frames with < 5% of their points left or an
        affine gain beyond e^0.7, keeping min_frames; (b) if the window is
        still full, the frame with the smallest distance score (the first
        keyframe exempt)."""
        active = sorted((k for k in self.keyframes if k.slot is not None),
                        key=lambda k: k.kf_id)
        if len(active) < 2:
            return []
        latest = active[-1]
        min_frames = self.opt.min_frames
        min_frame_age = self.opt.min_frame_age

        imm_kfs = [k for k in active if k.immature is not None]
        fetched = _fetch(self.ba_state.pt_valid, self.ba_state.pt_frame,
                         self.ba_state.aff,
                         *[k.immature.status for k in imm_kfs])
        pt_valid, pt_frame, aff = fetched[:3]
        pt_frame = pt_frame.astype(np.int64)
        valid_per_slot = np.bincount(pt_frame[pt_valid != 0],
                                     minlength=len(self.kf_of_slot))
        imm_alive = {k: int(((st != 3) & (st != 2)).sum())
                     for k, st in zip(imm_kfs, fetched[3:])}

        flagged: List[Keyframe] = []
        for kf in active:
            n_alive_imm = imm_alive.get(kf, kf.n_immature)
            n_pts = int(valid_per_slot[kf.slot])
            kf.n_points_total = max(kf.n_points_total, n_pts)
            n_in = n_pts + n_alive_imm
            n_total = max(kf.n_points_total + kf.n_immature, 1)
            log_aff = abs(float(aff[latest.slot, 0] - aff[kf.slot, 0]))
            if ((n_in < 0.05 * n_total or log_aff > 0.7)
                    and len(active) - len(flagged) > min_frames):
                flagged.append(kf)

        if len(active) - len(flagged) >= self.opt.max_keyframes:
            centers = {k.kf_id: k.c2w[:3, 3] for k in active}
            c_latest = centers[latest.kf_id]
            best, smallest = None, 1.0       # real scores are <= 0
            for kf in active:
                if (kf.kf_id > latest.kf_id - min_frame_age
                        or kf.kf_id == 0 or kf in flagged):
                    continue
                dist_score = 0.0
                for other in active:
                    if other.kf_id > latest.kf_id - min_frame_age + 1 \
                            or other is kf:
                        continue
                    d = np.linalg.norm(centers[kf.kf_id]
                                       - centers[other.kf_id])
                    dist_score += 1.0 / (1e-5 + d)
                dist_score *= -np.sqrt(
                    np.linalg.norm(centers[kf.kf_id] - c_latest))
                if dist_score < smallest:
                    smallest, best = dist_score, kf
            if best is None:                 # window of {first KF, latest}
                cands = [k for k in active if k not in flagged
                         and k is not latest]
                best = cands[0] if cands else None
            if best is not None:
                flagged.append(best)
        return flagged

    def _insert_points(self, kf: Keyframe, uv, idepth, ok):
        kf.n_points_total += int(np.asarray(ok).sum())
        self.ba_state, _ = _scatter_new_points(
            self.ba_state, kf.slot, self._tensor(uv), self._tensor(idepth),
            upload(ok, self.device, bool),
            kf.image)

    # ------------------------------------------------------------------
    def _make_keyframe(self, img, frame_id, timestamp, c2w, bgr,
                       from_init=False):
        tid = self.timer.start_timing("make_keyframe")
        kf = Keyframe(frame_id, timestamp, img, c2w)
        kf.bgr = bgr
        kf.kf_id = len(self.keyframes)
        if self.opt.rgbd and self._current_depth is not None:
            kf.sensor_depth, kf.sensor_depth_dev = self._current_depth
        # Marginalization selection runs before the new KF joins the
        # window; flagged frames still take part in the BA below.
        t_flag = self.timer.start_timing("kf_flag")
        flagged = [] if from_init else self._flag_frames_for_marginalization()
        self.keyframes.append(kf)
        self._assign_slot(kf)
        self.timer.end_timing("kf_flag", t_flag)

        t_act = self.timer.start_timing("kf_activate")
        n_valid_pre_act = (int(self.ba_state.pt_valid.sum())
                           if self.logger is not None else 0)
        if not from_init:
            # Free the slots of points that left the window's view before
            # activating new ones (documented deviation, fixed pool).
            tgt_c2w = self._tensor(c2w)
            self.ba_state = _drop_oob_points(self.ba_state, tgt_c2w, self.K,
                                             self.H, self.W)
            for host_kf in self.kf_of_slot:
                if (host_kf is None or host_kf is kf
                        or host_kf.immature is None
                        or host_kf.slot is None):
                    continue
                self.ba_state, host_kf.immature = _activate_and_insert(
                    self.ba_state, host_kf.immature, host_kf.slot,
                    host_kf.c2w_on(self.device), tgt_c2w, img, host_kf.image,
                    self.K)
        self.timer.end_timing("kf_activate", t_act)
        # RGB-D: points of the new keyframe straight from its sensor depth
        # (makeNewTraces' GT seeding: idepth_min = idepth_max = 1/depth).
        if kf.sensor_depth is not None:
            uv0, _ = self._select_uv(img)
            d0 = kf.sensor_depth[uv0[:, 1].astype(int), uv0[:, 0].astype(int)]
            self._insert_points(kf, uv0, 1.0 / np.maximum(d0, 0.05),
                                d0 > 0.05)

        mvs = self.backend.get_tracking_depth_map() if self.backend else None

        t_ba = self.timer.start_timing("kf_ba")
        self.ba_state, _ = ba_iterate(
            self.ba_state, self.slot_images, self.K,
            iters=self.opt.ba_iters, newest_slot=kf.slot)
        n_valid_post_ba = (int(self.ba_state.pt_valid.sum())
                           if self.logger is not None else 0)
        self.ba_state = remove_outliers(self.ba_state, self.slot_images,
                                        self.K)
        poses = _fetch(self.ba_state.poses)[0].astype(np.float32)
        self.timer.end_timing("kf_ba", t_ba)
        for slot, k in enumerate(self.kf_of_slot):
            if k is not None:
                moved = float(np.linalg.norm(poses[slot][:3, 3]
                                             - k.c2w[:3, 3]))
                if k.frame_id in self._lifetimes:
                    self._lifetimes[k.frame_id][1] += moved
                k.c2w = poses[slot]
        kf.c2w = poses[kf.slot]
        self.last_c2w = kf.c2w.copy()

        t_sel = self.timer.start_timing("kf_select")
        uv, n_sel = self._select_uv(img)
        kf.immature = make_immature(self._tensor(uv), img, id_min=0.05,
                                    id_max=5.0)
        kf.n_immature = min(n_sel, self.opt.immature_cap)
        self.timer.end_timing("kf_select", t_sel)
        self.windows.append(sorted(k.frame_id for k in self.kf_of_slot
                                   if k is not None))

        if self.logger is not None:
            self._stat_created += kf.n_immature
            n_post = int(self.ba_state.pt_valid.sum())
            self._stat_activated += max(n_valid_post_ba - n_valid_pre_act, 0)
            self._stat_dropped += max(n_valid_post_ba - n_post, 0)
            self._log_keyframe_stats(kf)
        for ow in self.outputs:
            ow.publish_keyframes(self.keyframes)

        if self.backend is not None:
            t_del = self.timer.start_timing("kf_deliver")
            self._deliver_dr_frame(kf)
            self.timer.end_timing("kf_deliver", t_del)

        t_ref = self.timer.start_timing("kf_set_ref")
        self._set_tracking_ref(kf, mvs)
        self.timer.end_timing("kf_set_ref", t_ref)
        self.ref_kf = kf

        # Marginalize the flagged frames last (makeKeyFrame order).
        for victim in flagged:
            if victim.slot is not None:
                self._marginalize_kf(victim)
        self.timer.end_timing("make_keyframe", tid)

    def _deliver_dr_frame(self, kf: Keyframe):
        """deliverDrFrame (FullSystem.cpp:1122-1198): send the newest
        view_num keyframes of the window to the backend; depth range
        [0.01, 3 / idepth_quantile(0.2)]."""
        active = sorted((k for k in self.kf_of_slot
                         if k is not None and k.bgr is not None),
                        key=lambda k: k.frame_id)
        if len(active) < self.opt.mvs_view_num:
            return
        window = active[-self.opt.mvs_view_num:]
        if not self.backend.ready():
            # linearize mode waits for the backend; real-time mode drops.
            if self.opt.linearize:
                self.backend.wait()
            else:
                self.n_dropped_kf += 1
                return
        idep, pt_valid = _fetch(self.ba_state.pt_idepth,
                                self.ba_state.pt_valid)
        idv = idep.astype(np.float32)[pt_valid != 0]
        if len(idv) > 0:
            dmax = 3.0 / max(reference_idepth_quantile(idv, 0.2), 1e-3)
        else:
            dmax = 10.0
        self.backend.call(
            bgrs=[k.bgr for k in window],
            cam_to_worlds=[k.c2w for k in window],
            depth_min=0.01, depth_max=float(dmax),
            next_ref_c2w=kf.c2w,
            discard_percentage=self.opt.mvs_discard_percentage)

    def _set_tracking_ref(self, kf: Keyframe, mvs: Optional[dict]):
        """setCoarseTrackingRef with the TSDF-rendered dense injection
        (FullSystem.cpp:1373-1387, CoarseTracker.cpp:633-733)."""
        self._first_coarse_rmse = None
        ref_c2w = kf.c2w_on(self.device)
        idepth0, weight0 = _project_ba_points(self.ba_state, ref_c2w, self.K,
                                              self.H, self.W)
        if self.opt.debug_save_depth_images:
            # saveKFDepthMap right after the new tracking reference is set
            # (FullSystem.cpp:1386, CoarseTracker.cpp:1073-1135).
            idep, wgt = _fetch(idepth0, weight0)
            save_depth_png(self.opt.depth_save_folder, kf.frame_id, idep,
                           wgt)
        dense_id = dense_w = None
        if kf.sensor_depth is not None:
            # RGB-D: the dense injection is the sensor depth on the
            # tracking grid.
            depth = kf.sensor_depth_dev
            st = self.opt.tracking_step
            gy = torch.arange(self.H, device=self.device) % st == 0
            gx = torch.arange(self.W, device=self.device) % st == 0
            use = (depth > 0.05) & gy[:, None] & gx[None, :]
            dense_id = torch.where(use, 1.0 / torch.clamp(depth, min=0.05),
                                   torch.zeros_like(depth))
            dense_w = use.float()
        elif (self.opt.dense_tracking and mvs is not None
                and mvs.get("valid")):
            dense_id, dense_w = splat_depth_to_ref(
                mvs["depth"], self._tensor(mvs["c2w"]), ref_c2w,
                self._tensor(self.K_mat), self.H, self.W,
                stride=self.opt.tracking_step)
        self.tracker_ref = make_tracker_ref(
            kf.image, *self.K, sparse_idepth=idepth0, sparse_weight=weight0,
            dense_idepth=dense_id, dense_weight=dense_w)
        # RGB-D: the dvo reference pyramid of the new tracking reference
        # (HessianBlocks.h:307-319). A keyframe without depth drops the old
        # one, so dense_match never runs against a stale reference; such
        # frames take the track_frame path.
        if self.opt.rgbd and kf.sensor_depth is not None:
            self._dvo_ref = build_rgbd_pyramid(kf.image, kf.sensor_depth_dev,
                                               *self.K, num_levels=2)
        elif self.opt.rgbd:
            self._dvo_ref = None

    def _trace_on_frame(self, img, c2w):
        """traceNewCoarse: update the immature points of the window's
        keyframes against the new frame (FullSystem.cpp:650-)."""
        tgt = self._tensor(c2w)
        for kf in self.kf_of_slot:
            if kf is not None and kf.immature is not None:
                kf.immature = trace_points(kf.immature,
                                           kf.c2w_on(self.device), tgt, img,
                                           self.K)

    def _log_keyframe_stats(self, kf: Keyframe):
        """printLogLine + printEigenValLine per keyframe
        (FullSystem.cpp:1664-1781): numsLog counters and the eigen spectra,
        diagonal, variances and nullspace quadratic forms of the
        Schur-reduced window system (lastHS/lastbS), in one host read."""
        H_log, b_log, ns, n_res, aff = _fetch(
            *ba_log_system(self.ba_state, self.slot_images, self.K),
            self.ba_state.aff)
        active = sorted((k for k in self.kf_of_slot if k is not None),
                        key=lambda k: k.kf_id)
        # Calib + active-slot rows in window order (DSO's lastHS spans only
        # live frames; this system carries every slot).
        idx = np.asarray(list(range(4)) + [4 + k.slot * 8 + j
                                           for k in active for j in range(8)])
        rmse = self._last_energy if self._last_energy is not None else 0.0
        self.logger.log_nums(
            kf.frame_id, rmse, self._stat_created, self._stat_activated,
            self._stat_dropped, self.opt.ba_iters, int(n_res),
            float(aff[kf.slot, 0]), float(aff[kf.slot, 1]),
            active[-1].frame_id - active[0].frame_id, len(active))
        self.logger.log_eigenvalues(
            kf.frame_id, H_log[np.ix_(idx, idx)], b_log[idx], ns[idx],
            len(active))

    # ------------------------------------------------------------------
    def write_results(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        write_result_tum(os.path.join(out_dir, "result.txt"), self.all_ts,
                         self.all_poses)
        write_poses_mat(os.path.join(out_dir, "poses_dso.txt"), self.all_ids,
                        self.all_poses)
        write_poses_mat(os.path.join(out_dir, "keyframes_dso.txt"),
                        [kf.frame_id for kf in self.keyframes],
                        [kf.c2w for kf in self.keyframes])
        write_optimization_windows(
            os.path.join(out_dir, "dso_optimization_windows.txt"),
            self.windows)
        if self.logger is not None:
            # printFrameLifetimes runs at shutdown (FullSystem dtor path)
            self.logger.log_lifetimes(
                [(fid, rec[0], 0, 0, rec[1])
                 for fid, rec in sorted(self._lifetimes.items())])
            self.logger.close()


def _abs_grad2(img):
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx * gx + gy * gy


def _select_counts(img, f0: float):
    """Candidate counts for every (factor, potential) the density
    adaptation can visit: one (5,) tensor, read once."""
    g2 = _abs_grad2(img)
    return torch.stack([
        select_pixels(g2, potential=p, threshold_factor=f).long().sum()
        for f, p in ((f0, 4), (f0, 8), (f0, 2), (f0, 1), (f0 * 0.4, 1))])


def _select_uv_device(img, threshold_factor: float, potential: int,
                      cap: int):
    """Select pixels and extract their (x, y) on the device, equal to
    np.nonzero(mask) + np.linspace(0, n-1, cap).astype(int) subsampling:
    the k-th kept rank is (k*(n-1))//(cap-1) and searchsorted finds its
    pixel. Entries past the n-th are zero. :return: (uv (cap, 2) float32
    numpy, n)."""
    H, W = img.shape
    mask = select_pixels(_abs_grad2(img), potential=potential,
                         threshold_factor=threshold_factor)
    csum = torch.cumsum(mask.reshape(-1).long(), 0)
    n = csum[-1]
    k = torch.arange(cap, device=img.device)
    t = torch.where(n > cap, (k * torch.clamp(n - 1, min=0)) // (cap - 1), k)
    idx = torch.searchsorted(csum, t + 1)
    uv = torch.stack([(idx % W).float(), (idx // W).float()], -1)
    uv = torch.where((t < n)[:, None], uv, torch.zeros_like(uv))
    uv_np, n_np = _fetch(uv, n)
    return uv_np.astype(np.float32), int(n_np)


def _assign_slot_state(state: BAState, slot_images, slot: int, c2w, image):
    """Write a keyframe into BA slot ``slot`` (pose, affine, FEJ point,
    image)."""
    def put(t, v):
        t = t.clone()
        t[slot] = v
        return t
    z2 = torch.zeros(2, device=image.device)
    return state._replace(
        poses=put(state.poses, c2w), aff=put(state.aff, z2),
        frame_valid=put(state.frame_valid, True),
        poses_lin=put(state.poses_lin, c2w),
        aff_lin=put(state.aff_lin, z2)), put(slot_images, image)


def _scatter_new_points(state: BAState, slot: int, uv, idepth, ok, image):
    """Rank-compact the ``ok`` candidates into free BA point slots and write
    all point fields (colours sampled from the host image).

    Destinations are distinct (free slots taken by distinct ranks); the
    rest go to a spare row that is cut off (``.at[].set(mode="drop")``).
    :return: (new BAState, use mask of the candidates that got a slot)
    """
    N = state.pt_valid.shape[0]
    dev = uv.device
    free = ~state.pt_valid
    free_rank = torch.cumsum(free.long(), 0) - 1
    slot_of_rank = torch.zeros(N + 1, dtype=torch.long, device=dev)
    slot_of_rank[torch.where(free, free_rank, torch.full_like(free_rank, N))] \
        = torch.arange(N, device=dev)
    n_free = free.long().sum()

    ok_rank = torch.cumsum(ok.long(), 0) - 1
    use = ok & (ok_rank < n_free)
    dest = torch.where(use, slot_of_rank[:N][torch.clamp(ok_rank, 0, N - 1)],
                       torch.full_like(ok_rank, N))

    pat = pattern(dev)
    u = uv[:, 0:1] + pat[:, 0]
    v = uv[:, 1:2] + pat[:, 1]
    colors = _bilinear(image, u.reshape(-1), v.reshape(-1)).reshape(-1, 8)

    def put(t, vals):
        ext = torch.cat([t, t[:1]])          # the spare row N
        ext[dest] = vals.to(t.dtype)
        return ext[:N]
    return state._replace(
        pt_frame=put(state.pt_frame, torch.full_like(dest, slot)),
        pt_uv=put(state.pt_uv, uv),
        pt_idepth=put(state.pt_idepth, torch.clamp(idepth, min=1e-3)),
        pt_color=put(state.pt_color, colors),
        pt_valid=put(state.pt_valid, torch.ones_like(ok))), use


def _points_world(state: BAState, K):
    fx, fy, cx, cy = K
    ray = torch.stack([(state.pt_uv[:, 0] - cx) / fx,
                       (state.pt_uv[:, 1] - cy) / fy,
                       torch.ones_like(state.pt_uv[:, 0])], -1)
    pts_h = ray / torch.clamp(state.pt_idepth[:, None], min=1e-6)
    hposes = state.poses[state.pt_frame]
    return (torch.einsum("nij,nj->ni", hposes[:, :3, :3], pts_h)
            + hposes[:, :3, 3])


def _drop_oob_points(state: BAState, newest_c2w, K, H: int, W: int):
    """flagPointsForRemoval (FullSystem.cpp:888-935 + isOOB,
    HessianBlocks.h:528): a point leaves the active set when it projects
    into fewer than 2 window frames other than its host, or its idepth is
    not positive."""
    fx, fy, cx, cy = K
    pts_w = _points_world(state, K)
    R_all = state.poses[:, :3, :3].transpose(-1, -2)
    t_all = -torch.einsum("fij,fj->fi", R_all, state.poses[:, :3, 3])
    pr = torch.einsum("fij,nj->fni", R_all, pts_w) + t_all[:, None, :]
    z = torch.clamp(pr[..., 2], min=1e-6)
    u = fx * pr[..., 0] / z + cx
    v = fy * pr[..., 1] / z + cy
    vis = ((pr[..., 2] > 0.01) & (u >= 1.0) & (u <= W - 2.0)
           & (v >= 1.0) & (v <= H - 2.0)) & state.frame_valid[:, None]
    F = state.poses.shape[0]
    not_host = (torch.arange(F, device=pts_w.device)[:, None]
                != state.pt_frame[None, :])
    n_targets = (vis & not_host).sum(0)
    keep = (n_targets >= 2) & (state.pt_idepth > 0)
    return state._replace(pt_valid=state.pt_valid & keep)


def _project_ba_points(state: BAState, ref_c2w, K, H: int, W: int):
    """Active BA points into level-0 idepth/weight maps of the new reference
    keyframe (makeCoarseDepthL0's input); the nearest point wins a pixel."""
    fx, fy, cx, cy = K
    pts_w = _points_world(state, K)
    R = ref_c2w[:3, :3].T
    t = -R @ ref_c2w[:3, 3]
    pts_r = pts_w @ R.T + t
    z = pts_r[:, 2]
    good = state.pt_valid & (z > 0.01)
    zs = torch.clamp(z, min=1e-6)
    u = torch.round(fx * pts_r[:, 0] / zs + cx).to(torch.int32).long()
    v = torch.round(fy * pts_r[:, 1] / zs + cy).to(torch.int32).long()
    good = good & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    flat = torch.where(good, v * W + u, torch.full_like(u, H * W))
    # amax is order-independent: the same result on every run.
    idepth = torch.zeros(H * W + 1, device=zs.device).scatter_reduce_(
        0, flat, 1.0 / zs, reduce="amax")
    weight = torch.zeros(H * W + 1, device=zs.device).scatter_reduce_(
        0, flat, torch.ones_like(zs), reduce="amax")
    return idepth[:H * W].reshape(H, W), weight[:H * W].reshape(H, W)


def _activate_and_insert(state: BAState, pts, host_slot: int, host_c2w,
                         tgt_c2w, tgt_img, host_img, K):
    """Activate the matured immature points and write them into free BA
    point slots, on the device. :return: (new BAState, ImmaturePoints
    without the activated ones)."""
    idep, ok = activate_points(pts, host_c2w, tgt_c2w, tgt_img, K)
    new_state, use = _scatter_new_points(state, host_slot, pts.uv, idep, ok,
                                         host_img)
    return new_state, pts._replace(valid=pts.valid & ~use)
