"""DSO-style dataset reader: image folders or zips with times.txt,
geometric and photometric undistortion, and RGB-D depth folders.

Port of ``ImageFolderReader`` and ``RGBDReader`` from
``tandem_tpu/data/reader.py`` (parity
target tandem/src/util/DatasetReader.h:115-505): an alphabetically sorted
folder or zip of images, an optional times.txt ("id timestamp [exposure]"),
and per image an intensity image for tracking plus a BGR image for the MVS
path. PNG files are decoded with numpy (``data/replica.py``: equal to
cv2.imread and COLOR_BGR2GRAY); any other format raises. There is no
background prefetch (the JAX package's native loader): ``preload`` is not
ported.
"""

from __future__ import annotations

import os
import zipfile
from typing import List, Optional, Tuple

import numpy as np

from .replica import decode_png, gray, read_png
from .undistort import PhotometricUndistorter, Undistort, remap_u8

_IMAGE_SUFFIXES = (".jpg", ".png", ".jpeg")


def _bgr8(img: np.ndarray) -> np.ndarray:
    """A decoded PNG as cv2.imread(IMREAD_COLOR) returns it: 3-channel
    uint8 BGR (grey replicated, alpha dropped, 16 bits cut to 8)."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    if img.shape[2] == 2:                      # grey + alpha
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])


class ImageFolderReader:
    def __init__(self, path: str, calib: Optional[str] = None,
                 gamma: Optional[str] = None, vignette: Optional[str] = None,
                 preload: bool = False):
        if preload:
            raise NotImplementedError(
                "preload (the native prefetch loader, native_bridge.py) is "
                "not ported: ROADMAP Queue 1, native bridge")
        self.path = path
        self.zip = None
        if path.endswith(".zip"):
            self.zip = zipfile.ZipFile(path)
            self.files = sorted(n for n in self.zip.namelist()
                                if n.lower().endswith(_IMAGE_SUFFIXES))
        else:
            self.files = sorted(f for f in os.listdir(path)
                                if f.lower().endswith(_IMAGE_SUFFIXES))

        self.undistort = Undistort.from_file(calib) if calib else None
        size = ((self.undistort.w, self.undistort.h)
                if self.undistort else None)
        self.photometric = PhotometricUndistorter(gamma, vignette, size)

        self.timestamps: List[float] = []
        self.exposures: List[float] = []
        self._load_timestamps()
        self._last = (-1, None)   # (idx, bgr): get_image + get_image_bgr

    def _load_timestamps(self):
        """times.txt: 'id timestamp [exposure]' (DatasetReader.h:414)."""
        times_file = (os.path.join(os.path.dirname(self.path.rstrip("/")),
                                   "times.txt")
                      if not self.zip else None)
        candidates = [times_file,
                      os.path.join(self.path, "..", "times.txt")
                      if not self.zip else None]
        for cand in candidates:
            if cand and os.path.exists(cand):
                for line in open(cand):
                    parts = line.split()
                    if len(parts) >= 2:
                        self.timestamps.append(float(parts[1]))
                        self.exposures.append(
                            float(parts[2]) if len(parts) >= 3 else 1.0)
                break
        if not self.timestamps:
            self.timestamps = [i / 30.0 for i in range(len(self.files))]
            self.exposures = [1.0] * len(self.files)

    def _read_raw(self, idx: int) -> np.ndarray:
        if self._last[0] == idx:
            return self._last[1]
        name = self.files[idx]
        if not name.lower().endswith(".png"):
            raise ValueError(f"{name}: only PNG images can be decoded "
                             "without an image library")
        if self.zip is not None:
            data = self.zip.read(name)
        else:
            with open(os.path.join(self.path, name), "rb") as f:
                data = f.read()
        bgr = _bgr8(decode_png(data, name))
        self._last = (idx, bgr)
        return bgr

    def __len__(self):
        return len(self.files)

    def get_timestamp(self, idx: int) -> float:
        """Timestamp only (no decode): timed-playback scheduling."""
        return self.timestamps[idx]

    def get_image(self, idx: int) -> Tuple[np.ndarray, float, float]:
        """:return: (intensity (H, W) after undistortion and photometric
        correction, timestamp, exposure). uint8 when the photometric
        calibration is identity and no undistortion runs, else float32."""
        gray_u8 = gray(self._read_raw(idx))
        if self.photometric.is_identity:
            if self.undistort is not None:
                gray_u8 = remap_u8(gray_u8, self.undistort.remap_x,
                                   self.undistort.remap_y)
            return gray_u8, self.timestamps[idx], self.exposures[idx]
        img = self.photometric.process(gray_u8)
        if self.undistort is not None:
            img = remap_u8(np.clip(img, 0, 255).astype(np.uint8),
                           self.undistort.remap_x, self.undistort.remap_y)
        return img.astype(np.float32), self.timestamps[idx], \
            self.exposures[idx]

    def get_image_bgr(self, idx: int) -> np.ndarray:
        """Undistorted BGR uint8 for the MVS path
        (getImageBGR_8UC3_undis, DatasetReader.h:270)."""
        bgr = self._read_raw(idx)
        if self.undistort is not None:
            out = remap_u8(bgr, self.undistort.remap_x,
                           self.undistort.remap_y)
            return np.clip(out, 0, 255).astype(np.uint8)
        return bgr


class RGBDReader(ImageFolderReader):
    """Adds 16-bit depth PNGs from a sibling 'depth' directory
    (DatasetReader.h:506 RGBDReader), decoded with numpy."""

    def __init__(self, path: str, depth_path: Optional[str] = None,
                 depth_scale: float = 1.0 / 5000.0, **kwargs):
        super().__init__(path, **kwargs)
        self.depth_path = depth_path or os.path.join(
            os.path.dirname(path.rstrip("/")), "depth")
        self.depth_scale = depth_scale
        self.depth_files = sorted(
            f for f in os.listdir(self.depth_path)
            if f.lower().endswith(".png"))

    def get_depth(self, idx: int) -> np.ndarray:
        """(H, W) float32 metres: the raw value times depth_scale (in
        float32, as the JAX reader computes it)."""
        d = read_png(os.path.join(self.depth_path, self.depth_files[idx]))
        return d.astype(np.float32) * self.depth_scale
