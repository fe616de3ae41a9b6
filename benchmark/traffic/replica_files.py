"""A rendered scene written in the Replica-TANDEM-Ext layout that the
program's training loader reads (the layout of
``tests/fixtures/make_replica_mini.py``):

    <root>/train.txt                 the scene's name
    <root>/scene0/camera.txt         "fx fy cx cy 0" and "W H"
    <root>/scene0/poses_gt.txt       "index m00 ... m33" a frame
    <root>/scene0/tuples_dso_optimization_windows.txt   "V f0 .. f6 1.0"
    <root>/scene0/images/%06d.png    RGB, 8 bits
    <root>/scene0/depths/%06d.png    grey, 16 bits: metres / scale
    <root>/scene0/depths/scale.txt

PNGs are written unfiltered with zlib at level 1: the files are made anew
for every run, and the loader's decoder does a real file's inflate.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

DEPTH_SCALE = 2.0e-4      # metres per 16-bit unit (13.1 m at most)


def png_bytes(img: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB or uint16 (H, W) grey as PNG bytes."""
    h, w = img.shape[:2]
    if img.dtype == np.uint16:
        rows = img.astype(">u2").reshape(h, -1).view(np.uint8)
        depth, colour = 16, 0
    else:
        rows = img.reshape(h, -1)
        depth, colour = 8, 2
    raw = np.hstack([np.zeros((h, 1), np.uint8), rows])

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    hdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + chunk(b"IEND", b""))


def depth_units(depth: np.ndarray) -> np.ndarray:
    """Metres as the 16-bit units the depth PNGs store."""
    return np.clip(np.round(depth / DEPTH_SCALE), 0, 65535).astype(np.uint16)


def write_scene(root: str, K: np.ndarray, width: int, height: int,
                rgbs, depths, poses, tuples) -> str:
    """Write the scene; ``rgbs`` uint8 (N, H, W, 3), ``depths`` float32
    metres (N, H, W), ``poses`` (N, 4, 4) c2w, ``tuples`` lists of frame
    indices. Returns the scene directory."""
    scene = os.path.join(root, "scene0")
    os.makedirs(os.path.join(scene, "images"), exist_ok=True)
    os.makedirs(os.path.join(scene, "depths"), exist_ok=True)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("scene0\n")
    with open(os.path.join(scene, "camera.txt"), "w") as f:
        f.write(f"{K[0, 0]} {K[1, 1]} {K[0, 2]} {K[1, 2]} 0\n"
                f"{width} {height}\n")
    with open(os.path.join(scene, "depths", "scale.txt"), "w") as f:
        f.write(f"{DEPTH_SCALE}\n")
    with open(os.path.join(scene, "poses_gt.txt"), "w") as f:
        for i, p in enumerate(poses):
            f.write(f"{i} " + " ".join(f"{v:.9f}" for v in
                                       np.asarray(p).reshape(-1)) + "\n")
    with open(os.path.join(scene, "tuples_dso_optimization_windows.txt"),
              "w") as f:
        for t in tuples:
            f.write(f"{len(t)} " + " ".join(str(i) for i in t) + " 1.0\n")
    for i, (rgb, d) in enumerate(zip(rgbs, depths)):
        with open(os.path.join(scene, "images", f"{i:06d}.png"), "wb") as f:
            f.write(png_bytes(np.ascontiguousarray(rgb)))
        with open(os.path.join(scene, "depths", f"{i:06d}.png"), "wb") as f:
            f.write(png_bytes(depth_units(d)))
    return scene
