"""Live camera interface for the demo path.

Port of ``tandem_tpu/pipeline/camera.py`` (parity target
tandem/src/realsense/*: the D455 mono RGB stream wrapper, realsense.h:17,37
intrinsics -> DSO calib, and main_tandem_realsense.cpp). A small ABC with
a replay camera over a PNG folder, decoded by the host library's C decoder
(``native_bridge``). The JAX package's live UVC camera is OpenCV's
VideoCapture, which the card's machine lacks: ``OpenCVCamera`` raises.
"""

from __future__ import annotations

import os
from typing import Iterator, Tuple

import numpy as np

from ..native_bridge import read_bgr8


class Camera:
    """Mono RGB stream with pinhole intrinsics."""

    def intrinsics(self) -> Tuple[float, float, float, float, int, int]:
        """:return: fx, fy, cx, cy, width, height (DSO calib convention)."""
        raise NotImplementedError

    def frames(self) -> Iterator[Tuple[np.ndarray, float]]:
        """Yield (bgr uint8 HxWx3, timestamp seconds)."""
        raise NotImplementedError

    def write_calib(self, path: str):
        """Emit a DSO-format camera.txt (realsense.h intrinsics->calib)."""
        fx, fy, cx, cy, w, h = self.intrinsics()
        with open(path, "w") as f:
            f.write(f"Pinhole {fx} {fy} {cx} {cy} 0\n{w} {h}\n")
            f.write("none\n")
            f.write(f"{w} {h}\n")


class OpenCVCamera(Camera):
    def __init__(self, device: int = 0, width: int = 640, height: int = 480,
                 fov_deg: float = 70.0):
        raise NotImplementedError(
            "a live camera needs OpenCV's VideoCapture, which the port does "
            "not use (the card's machine has no OpenCV): replay a recorded "
            "image folder with replay=DIR calib=camera.txt")


class ReplayCamera(Camera):
    """Image-folder replay with the live-camera interface (demo testing):
    frame i is stamped i / FPS seconds."""

    FPS = 30.0

    def __init__(self, folder: str, calib: Tuple[float, float, float, float]):
        self.files = sorted(
            os.path.join(folder, f) for f in os.listdir(folder)
            if f.lower().endswith((".png", ".jpg", ".jpeg")))
        self.h, self.w = read_bgr8(self.files[0]).shape[:2]
        self.fx, self.fy, self.cx, self.cy = calib

    def intrinsics(self):
        return self.fx, self.fy, self.cx, self.cy, self.w, self.h

    def frames(self):
        for i, f in enumerate(self.files):
            yield read_bgr8(f), i / self.FPS
