"""TANDEM backend: MVSNet -> TSDF integrate -> render, one keyframe ahead.

Port of ``tandem_tpu/pipeline/backend.py`` (parity target
tandem/src/tandem/tandem_backend.{h,cpp}). Call N launches MVSNet(N)
asynchronously (the runner's own CUDA stream) and then finishes call N-1:
allocate its depth's truncation band, integrate the keyframe, render a depth
map at the next tracking reference pose and hand it to the coarse tracker
through the double-buffered ``TrackingDepthMap`` (the A/B swap under a
mutex, tandem_backend.cpp:93-96,183-190).

The MVSNet runs in the runner's dtype (float32 or bfloat16); the depth it
fuses is float32 either way. The fusion follows the JAX backend: integrate
walks every allocated block when at least half of them are in the
keyframe's frustum, else only the frustum-culled ones; the render at the
next tracking reference splats, per axis, only the blocks whose surface can
cross along that axis. Both culls are exact. Every ``mesh_extraction_freq``
calls, and on ``extract_mesh_now``, the global mesh is extracted
(``mapping/mesh.py``).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..mapping.mesh import extract_mesh
from ..mapping.tsdf import (TsdfConfig, allocate_blocks, create_volume,
                            grow_volume, integrate, integrate_culled,
                            render_depth_splat, surface_axis_slots,
                            visible_slots)
from ..utils.timer import Timer


class TrackingDepthMap:
    """Double-buffered rendered depth handed to the coarse tracker
    (TandemCoarseTrackingDepthMap A/B swap)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buf = [None, None]   # dicts: {'depth', 'c2w', 'valid'}
        self._read_idx = 0

    def write(self, depth, c2w: np.ndarray):
        with self._lock:
            widx = 1 - self._read_idx
            self._buf[widx] = {"depth": depth, "c2w": c2w, "valid": True}
            self._read_idx = widx

    def read(self) -> Optional[dict]:
        with self._lock:
            return self._buf[self._read_idx]


class TandemBackend:
    """One-keyframe-lookahead orchestrator."""

    def __init__(self, mvsnet_runner, tsdf_cfg: TsdfConfig, K: np.ndarray,
                 height: int, width: int, mesh_extraction_freq: int = 10,
                 timer: Optional[Timer] = None,
                 mesh_callback: Optional[Callable] = None):
        self.runner = mvsnet_runner
        self.device = mvsnet_runner.device  # the TSDF lives beside MVSNet
        self.cfg = tsdf_cfg
        self.K = np.asarray(K, np.float32)
        self.H, self.W = height, width
        self.timer = timer or Timer(enabled=False)
        self.mesh_freq = mesh_extraction_freq
        self.mesh_callback = mesh_callback
        self.last_mesh = None

        self.volume = create_volume(tsdf_cfg, self.device)
        self.depth_map = TrackingDepthMap()
        self.call_num = 0
        self._prev: Optional[dict] = None  # previous call's context
        self._n_drop_seen = 0     # pool-full allocation drops already handled
        self._pool_warned = False
        self.last_fuse: dict = {}  # counts of the latest fusion

    def ready(self) -> bool:
        """Reference Ready() parity (tandem_backend.cpp:285-287): True when
        there is no outstanding call or its MVSNet work has finished on the
        device. FullSystem drops the keyframe in real-time mode when False
        (FullSystem.cpp:1144-1151)."""
        return self._prev is None or self.runner.device_ready()

    def call(self, bgrs, cam_to_worlds, depth_min: float, depth_max: float,
             next_ref_c2w: np.ndarray, discard_percentage: float = 10.0):
        """Process one keyframe window (CallSequential semantics,
        tandem_backend.cpp:137-217): finish call N-1, then launch call N."""
        tid = self.timer.start_timing("backend_call")
        if self._prev is not None:
            self._fuse_previous(next_ref_c2w)
            if self.mesh_freq > 0 and self.call_num % self.mesh_freq == 0:
                self.extract_mesh_now()

        ref_index = self.runner.view_num - 2
        self.runner.call_async(bgrs, cam_to_worlds, self.K, depth_min,
                               depth_max, discard_percentage)
        self._prev = {"ref_c2w": np.asarray(cam_to_worlds[ref_index]),
                      "ref_bgr": np.asarray(bgrs[ref_index])}
        self.call_num += 1
        self.timer.end_timing("backend_call", tid)

    def _fuse_previous(self, next_ref_c2w):
        dev = self.device
        res = self.runner.get_result(device=True)
        depth = res["depth"]
        rgb = torch.from_numpy(np.ascontiguousarray(
            self._prev["ref_bgr"][..., ::-1], dtype=np.float32)).to(dev)
        K = torch.from_numpy(self.K).to(dev)
        pose = torch.from_numpy(
            np.asarray(self._prev["ref_c2w"], np.float32)).to(dev)

        self.volume = allocate_blocks(self.cfg, self.volume, depth, K, pose)
        # n_allocated and n_dropped are host counts; n_vis is read once,
        # after any growth (one host sync).
        slots, n_vis = visible_slots(self.cfg, self.volume, K, pose, self.H,
                                     self.W)
        # Pool exhaustion: the reference commits 10^6 blocks and aborts when
        # the heap runs dry (heap.cu:16-18); here the pool grows on demand
        # and the idempotent allocation picks up exactly the dropped blocks.
        # At pool_max: warn once and keep fusing what fits.
        while self.volume.n_dropped > self._n_drop_seen:
            self._n_drop_seen = self.volume.n_dropped
            if self.cfg.pool_size >= self.cfg.pool_max:
                if not self._pool_warned:
                    print(f"TSDF pool exhausted at pool_max="
                          f"{self.cfg.pool_max} blocks; new surface will "
                          f"not be fused (reference aborts here, "
                          f"heap.cu:16-18).")
                    self._pool_warned = True
                break
            self.cfg, self.volume = grow_volume(self.cfg, self.volume)
            self.volume = allocate_blocks(self.cfg, self.volume, depth, K,
                                          pose)
            slots, n_vis = visible_slots(self.cfg, self.volume, K, pose,
                                         self.H, self.W)
        n_alloc, n_vis = self.volume.n_allocated, int(n_vis)
        # The JAX backend's rule (kept for parity, not tuned for this
        # card): the contiguous full walk when most of the map is in view,
        # the slot gather/scatter of the culled walk otherwise.
        culled = n_vis < 0.5 * n_alloc
        if culled:
            self.volume = integrate_culled(self.cfg, self.volume, depth, rgb,
                                           K, pose, slots, n_vis)
        else:
            self.volume = integrate(self.cfg, self.volume, depth, rgb, K,
                                    pose)
        # The render cull reads the fused sdf, so it runs after integrate.
        pose_r = torch.from_numpy(
            np.asarray(next_ref_c2w, np.float32)).to(dev)
        ax_slots, ax_counts = surface_axis_slots(self.cfg, self.volume, K,
                                                 pose_r, self.H, self.W)
        ax_counts = ax_counts.tolist()
        rdepth = render_depth_splat(self.cfg, self.volume, K, pose_r,
                                    self.H, self.W, axis_slots=ax_slots,
                                    axis_counts=ax_counts)
        self.last_fuse = {"n_allocated": n_alloc, "n_visible": n_vis,
                          "culled_integrate": culled,
                          "axis_counts": ax_counts}
        self.depth_map.write(rdepth, np.asarray(next_ref_c2w))

    def stats(self) -> dict:
        """Volume occupancy counters (host integers — no device sync)."""
        return {"n_allocated": self.volume.n_allocated,
                "pool_size": self.cfg.pool_size,
                "pool_max": self.cfg.pool_max,
                "n_dropped": self._n_drop_seen,
                "call_num": self.call_num}

    def get_tracking_depth_map(self) -> Optional[dict]:
        return self.depth_map.read()

    def extract_mesh_now(self):
        """Extract the current global mesh: (vertices, faces, colours);
        the runtime also saves mesh.obj at shutdown
        (main_tandem_pangolin.cpp:296-303)."""
        tid = self.timer.start_timing("mesh")
        self.last_mesh = extract_mesh(self.cfg, self.volume)
        self.timer.end_timing("mesh", tid)
        if self.mesh_callback:
            self.mesh_callback(*self.last_mesh)
        return self.last_mesh

    def wait(self):
        """Block until the outstanding MVSNet call has finished on the
        runner's stream."""
        self.runner.wait()
