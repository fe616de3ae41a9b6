"""TANDEM backend: MVSNet -> TSDF integrate -> render, one keyframe ahead.

Port of ``tandem_tpu/pipeline/backend.py`` (parity target
tandem/src/tandem/tandem_backend.{h,cpp}). Call N launches MVSNet(N)
asynchronously (the runner's own CUDA stream) and then finishes call N-1:
allocate its depth's truncation band, integrate the keyframe, render a depth
map at the next tracking reference pose and hand it to the coarse tracker
through the double-buffered ``TrackingDepthMap`` (the A/B swap under a
mutex, tandem_backend.cpp:93-96,183-190).

The MVSNet runs in the runner's dtype (float32 or bfloat16); the depth it
fuses is float32 either way. Fusion takes one of two routes, by the device:

- on the card: allocate the keyframe's band (the one host read, for the
  pool counts), then ``integrate`` and ``render_depth_splat``'s full walk,
  each one launch of a kernel that culls inside itself (2 launches for the
  fill); no slot list, no other read;
- on the CPU, the JAX backend's: integrate walks every allocated block when
  at least half of them are in the keyframe's frustum, else only the
  frustum-culled ones; the render at the next tracking reference splats,
  per axis, only the blocks whose surface can cross along that axis, both
  culls sized by a host read.

Both give the same volume and render exactly. Every
``mesh_extraction_freq`` calls, and on ``extract_mesh_now``, the global
mesh is extracted (``mapping/mesh.py``).

``output_wrappers`` (Output3DWrapper sinks, tandem_backend.cpp's
pushDr* calls) get the periodic mesh and, for each fused keyframe, its
BGR image and its MVS depth and confidence, read to the host once a call
only when a sink is attached.

Spans (``utils/timer.py``, the backend's Timer, which it hands its runner):
``backend_call``; ``fusion`` around ``_fuse_previous``, holding
``mvsnet_result``, ``fusion_upload`` (the image's bytes, K and the two
cameras; on the card through pinned memory, without waiting for the
stream), one ``fusion_read`` for each deliberate host read (the
pool counts, with the allocation that needs them; on the CPU also the
visible count and the render's axis counts), each also a sample of the
counter ``fusion_host_reads``, and the enqueue of the rest:
``fusion_cull`` (the CPU's frustum and surface culls), ``fusion_integrate``
and ``fusion_render``; and ``fusion`` on the backend's stream from the
moment it holds the MVSNet's answer to the render's end. After each call
that fused a keyframe, the counter ``fusion_kernels`` samples 1 where the
card's kernels fused it and 0 where the CPU route did.
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
from ..utils.consts import upload
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
        if timer is not None:
            mvsnet_runner.timer = timer
        self.mesh_freq = mesh_extraction_freq
        self.mesh_callback = mesh_callback
        self.last_mesh = None

        self.volume = create_volume(tsdf_cfg, self.device)
        self.on_card = torch.device(self.device).type == "cuda"
        self.depth_map = TrackingDepthMap()
        self.call_num = 0
        self._prev: Optional[dict] = None  # previous call's context
        self._n_drop_seen = 0     # pool-full allocation drops already handled
        self._pool_warned = False
        self.last_fuse: dict = {}  # counts of the latest fusion
        self.output_wrappers = []

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
        fuses = self._prev is not None
        if fuses:
            res = self._fuse_previous(next_ref_c2w)
            if self.mesh_freq > 0 and self.call_num % self.mesh_freq == 0:
                self.extract_mesh_now()
                for ow in self.output_wrappers:
                    ow.push_dr_mesh(*self.last_mesh)
            if self.output_wrappers:
                depth, conf = torch.stack(
                    [res["depth"].float(), res["confidence"].float()]
                ).cpu().numpy()                      # one host read
                for ow in self.output_wrappers:
                    ow.push_dr_kf_image(self._prev["ref_bgr"])
                    ow.push_dr_kf_depth(depth, conf)

        ref_index = self.runner.view_num - 2
        self.runner.call_async(bgrs, cam_to_worlds, self.K, depth_min,
                               depth_max, discard_percentage)
        self._prev = {"ref_c2w": np.asarray(cam_to_worlds[ref_index]),
                      "ref_bgr": np.asarray(bgrs[ref_index])}
        self.call_num += 1
        self.timer.end_timing("backend_call", tid)
        if fuses:
            self.timer.count("fusion_kernels", int(self.on_card))

    def _fuse_previous(self, next_ref_c2w):
        with self.timer.span("fusion"):
            res = self.runner.get_result(device=True)
            dev = torch.device(self.device)
            stream = (torch.cuda.current_stream(dev) if dev.type == "cuda"
                      else None)
            with self.timer.device_span("fusion", stream):
                self._fuse(res["depth"], next_ref_c2w)
            return res

    def _host_read(self):
        """The span of a deliberate host read of the fusion, counted."""
        self.timer.count("fusion_host_reads")
        return self.timer.span("fusion_read")

    def _fuse(self, depth, next_ref_c2w):
        """Fuse the previous call's keyframe and render the tracker's depth
        at ``next_ref_c2w``."""
        dev = self.device
        with self.timer.span("fusion_upload"):
            # BGR bytes -> RGB floats [0, 255] on the device (exact)
            rgb = upload(self._prev["ref_bgr"], dev, np.uint8).flip(-1).float()
            K = upload(self.K, dev)
            pose = upload(self._prev["ref_c2w"], dev)
            pose_r = upload(next_ref_c2w, dev)
        self._allocate(depth, K, pose)
        n_alloc = self.volume.n_allocated
        if self.on_card:
            with self.timer.span("fusion_integrate"):
                self.volume = integrate(self.cfg, self.volume, depth, rgb, K,
                                        pose)
            with self.timer.span("fusion_render"):
                rdepth = render_depth_splat(self.cfg, self.volume, K, pose_r,
                                            self.H, self.W)
            self.last_fuse = {"n_allocated": n_alloc, "n_visible": None,
                              "culled_integrate": False, "axis_counts": None}
        else:
            rdepth = self._fuse_culled(depth, rgb, K, pose, pose_r)
        self.depth_map.write(rdepth, np.asarray(next_ref_c2w))

    def _allocate(self, depth, K, pose):
        """Allocate the keyframe's truncation band (one host read).

        Pool exhaustion: the reference commits 10^6 blocks and aborts when
        the heap runs dry (heap.cu:16-18); here the pool grows on demand
        and the idempotent allocation, run again, picks up exactly the
        dropped blocks. At pool_max: warn once and keep fusing what fits."""
        with self._host_read():
            self.volume = allocate_blocks(self.cfg, self.volume, depth, K,
                                          pose)
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
            with self._host_read():
                self.volume = allocate_blocks(self.cfg, self.volume, depth,
                                              K, pose)

    def _fuse_culled(self, depth, rgb, K, pose, pose_r):
        """The CPU route: the culled integrate and the axis-culled render,
        each sized by a host read. Returns the rendered depth."""
        with self.timer.span("fusion_cull"):
            slots, n_vis = visible_slots(self.cfg, self.volume, K, pose,
                                         self.H, self.W)
        with self._host_read():
            n_vis = int(n_vis)
        n_alloc = self.volume.n_allocated
        # The JAX backend's rule: the contiguous full walk when most of the
        # map is in view, the slot gather/scatter of the culled walk
        # otherwise.
        culled = n_vis < 0.5 * n_alloc
        with self.timer.span("fusion_integrate"):
            if culled:
                self.volume = integrate_culled(self.cfg, self.volume, depth,
                                               rgb, K, pose, slots, n_vis)
            else:
                self.volume = integrate(self.cfg, self.volume, depth, rgb, K,
                                        pose)
        # The render cull reads the fused sdf, so it runs after integrate.
        with self.timer.span("fusion_cull"):
            ax_slots, ax_counts = surface_axis_slots(self.cfg, self.volume,
                                                     K, pose_r, self.H,
                                                     self.W)
        with self._host_read():
            ax_counts = ax_counts.tolist()
        with self.timer.span("fusion_render"):
            rdepth = render_depth_splat(self.cfg, self.volume, K, pose_r,
                                        self.H, self.W, axis_slots=ax_slots,
                                        axis_counts=ax_counts)
        self.last_fuse = {"n_allocated": n_alloc, "n_visible": n_vis,
                          "culled_integrate": culled,
                          "axis_counts": ax_counts}
        return rdepth

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
