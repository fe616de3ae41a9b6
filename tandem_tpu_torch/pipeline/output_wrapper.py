"""Output sinks: the Output3DWrapper abstraction.

Parity target: tandem/src/IOWrapper/Output3DWrapper.h:131-219 — the abstract
publisher interface the runtime pushes poses, keyframes, depth images, MVS
depth/confidence, and meshes through (including the TANDEM extensions
pushDrKfImage / pushDrKfDepth / pushDrMesh :200-219). The Pangolin GUI is
replaced by headless sinks: a file recorder, a null sink and the panel
recorder; any GUI can subclass the same interface.

Port of ``tandem_tpu/pipeline/output_wrapper.py``; PNGs are written by
``data/replica.write_png`` (the card's machine has no OpenCV). The sinks
take numpy arrays: whoever pushes reads device tensors to the host first.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ..data.replica import write_png


class Output3DWrapper:
    """Abstract sink; all methods optional no-ops."""

    def publish_cam_pose(self, frame_id: int, c2w: np.ndarray):
        pass

    def publish_keyframes(self, keyframes):
        pass

    def push_live_frame(self, image: np.ndarray):
        pass

    def push_depth_image(self, depth: np.ndarray):
        pass

    # TANDEM extensions (Output3DWrapper.h:200-219)
    def push_dr_kf_image(self, bgr: np.ndarray):
        pass

    def push_dr_kf_depth(self, depth: np.ndarray, confidence: np.ndarray):
        pass

    def push_dr_mesh(self, vertices: np.ndarray, faces: np.ndarray,
                     colors: Optional[np.ndarray] = None):
        pass

    def join(self):
        pass


class NullOutputWrapper(Output3DWrapper):
    pass


class FileOutputWrapper(Output3DWrapper):
    """Records pushed artifacts to disk (headless GUI replacement): the
    poses in memory, each keyframe depth as a 16-bit PNG normalised to its
    maximum, each mesh as an OBJ."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.poses: List[tuple] = []
        self.kf_count = 0
        self.mesh_count = 0

    def publish_cam_pose(self, frame_id, c2w):
        self.poses.append((frame_id, np.asarray(c2w)))

    def push_dr_kf_depth(self, depth, confidence):
        d = np.asarray(depth)
        path = os.path.join(self.out_dir, f"kf_depth_{self.kf_count:06d}.png")
        write_png(path, (np.clip(d / max(d.max(), 1e-6), 0, 1)
                         * 65535).astype(np.uint16))
        self.kf_count += 1

    def push_dr_mesh(self, vertices, faces, colors=None):
        from ..mapping.mesh import save_obj
        save_obj(os.path.join(self.out_dir,
                              f"mesh_{self.mesh_count:04d}.obj"),
                 vertices, faces, colors)
        self.mesh_count += 1


def _rainbow(x: np.ndarray) -> np.ndarray:
    """Map [0, 1] -> BGR uint8 with the viewer's rainbow ramp
    (makeRainbow3B, PangolinDSOViewer/ImageDisplay semantics: blue = far /
    small idepth through green to red = near)."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    return (np.stack([b, g, r], -1) * 255).astype(np.uint8)


class PanelOutputWrapper(Output3DWrapper):
    """Viewer-grade headless rendering: per-keyframe panels
    [input | rainbow inverse depth | confidence] written as numbered PNGs
    (ffmpeg-ready), matching what PangolinDSOViewer renders for
    pushDrKfImage/pushDrKfDepth (Output3DWrapper.h:200-219,
    PangolinDSOViewer.cpp:803)."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.kf_count = 0
        self._last_bgr: Optional[np.ndarray] = None

    def push_dr_kf_image(self, bgr):
        self._last_bgr = np.asarray(bgr)

    def push_dr_kf_depth(self, depth, confidence):
        d = np.asarray(depth, np.float32)
        c = np.asarray(confidence, np.float32)
        valid = d > 0
        # Normalize inverse depth over the valid support (the viewer scales
        # by the current idepth range).
        idep = np.where(valid, 1.0 / np.maximum(d, 1e-6), 0.0)
        hi = np.percentile(idep[valid], 98) if valid.any() else 1.0
        panel_d = _rainbow(idep / max(hi, 1e-6))
        panel_d[~valid] = 0
        panel_c = (np.clip(c, 0, 1)[..., None] * 255).astype(
            np.uint8).repeat(3, -1)
        img = self._last_bgr
        if img is None or img.shape[:2] != d.shape:
            img = np.zeros(d.shape + (3,), np.uint8)
        panel = np.concatenate(
            [img.astype(np.uint8), panel_d, panel_c], axis=1)
        # BGR panel -> an RGB file, as cv2.imwrite stores it
        write_png(os.path.join(self.out_dir,
                               f"dr_kf_{self.kf_count:06d}.png"),
                  np.ascontiguousarray(panel[..., ::-1]))
        self.kf_count += 1
