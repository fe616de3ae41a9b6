"""Pinhole intrinsics (copy of tandem_tpu.core.camera's numpy helpers; the
port cannot import the JAX package).

Pixel centres sit at integer coordinates (half_pixel_centers=False, the DSO
convention, cva_mvsnet/models/datasets.py:104-174). Two ways to build the
per-stage intrinsics:

- ``stage_intrinsics_exact``: the training/eval path, which resizes the
  camera with half-pixel-aware centring (datasets.py:144-174);
- ``stage_intrinsics_runtime``: the C++ runtime naively multiplies the first
  two rows of K by 0.25/0.5 (dr_mvsnet.cpp:226-247 skips the +0.5
  half-pixel correction); the runner replicates that for parity with the
  deployed model.
"""

from __future__ import annotations

import numpy as np


def cam_intrinsics(height=None, width=None, fx=None, cx=None, fy=None, cy=None,
                   cam=None, dtype=None):
    dtype = dtype if dtype is not None else cam["K"].dtype
    height = height if height is not None else cam["height"]
    width = width if width is not None else cam["width"]
    fx = fx if fx is not None else cam["K"][0, 0]
    cx = cx if cx is not None else cam["K"][0, 2]
    fy = fy if fy is not None else cam["K"][1, 1]
    cy = cy if cy is not None else cam["K"][1, 2]
    return {
        "K": np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=dtype),
        "height": int(height),
        "width": int(width),
    }


def cam_resize(cam: dict, height: int, width: int) -> dict:
    """Half-pixel-aware intrinsics rescale (datasets.py:144-174 semantics)."""
    center_x = 0.5 * float(cam["width"] - 1)
    center_y = 0.5 * float(cam["height"] - 1)
    orig_cx_diff = cam["K"][0, 2] - center_x
    orig_cy_diff = cam["K"][1, 2] - center_y
    scaled_center_x = 0.5 * float(width - 1)
    scaled_center_y = 0.5 * float(height - 1)
    scale_x = float(width) / float(cam["width"])
    scale_y = float(height) / float(cam["height"])
    return cam_intrinsics(
        height=height, width=width,
        fx=scale_x * cam["K"][0, 0], fy=scale_y * cam["K"][1, 1],
        cx=scaled_center_x + scale_x * orig_cx_diff,
        cy=scaled_center_y + scale_y * orig_cy_diff,
        dtype=cam["K"].dtype)


def cam_stack(cams: list) -> dict:
    cam0 = cams[0]
    if not all(cam0["width"] == c["width"] and cam0["height"] == c["height"]
               for c in cams):
        raise ValueError("cam_stack: the cameras differ in size")
    return {"K": np.stack([c["K"] for c in cams]),
            "width": cam0["width"], "height": cam0["height"]}


def scale_K_naive(K: np.ndarray, scale: float) -> np.ndarray:
    """Naive first-two-rows scaling (the runtime C++ behaviour,
    dr_mvsnet.cpp:226-247)."""
    K = np.array(K, copy=True)
    K[..., :2, :] = K[..., :2, :] * scale
    return K


def stage_intrinsics_exact(cam: dict):
    """Per-stage intrinsics for stages (1, 2, 3) at scales (1/4, 1/2, 1)
    using exact half-pixel-aware resizing."""
    h, w = cam["height"], cam["width"]
    s1 = cam_resize(cam, h // 4, w // 4)
    s2 = cam_resize(cam, h // 2, w // 2)
    return s1["K"], s2["K"], np.array(cam["K"], copy=True)


def stage_intrinsics_runtime(K: np.ndarray):
    """Per-stage intrinsics for stages (1, 2, 3) using the runtime's naive
    0.25x/0.5x scaling (replicates dr_mvsnet.cpp behaviour)."""
    return scale_K_naive(K, 0.25), scale_K_naive(K, 0.5), np.array(K, copy=True)
