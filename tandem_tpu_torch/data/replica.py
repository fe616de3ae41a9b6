"""Read a scene in the Replica (TANDEM) layout with numpy alone.

    scene/camera.txt         "fx fy cx cy 0" then "W H"
    scene/poses_gt.txt       "id" + 16 numbers of the 4x4 camera-to-world
    scene/images/%06d.png    8-bit RGB
    scene/depths/%06d.png    16-bit depth, metres = value * depths/scale.txt
    scene/tuples_dso_optimization_windows.txt  "n id_1 .. id_n scale"

The machine with the card has no image library, so PNG files are decoded
here (zlib + the five PNG row filters); ``gray`` is OpenCV's fixed-point
BGR -> grey conversion, which the JAX package's reader uses
(``tandem_tpu/data/reader.py``).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG colour type -> samples per pixel


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).astype(np.int32)
        pos += stride + 1
        if ftype == 0:
            cur = line
        elif ftype == 2:                                  # up
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):                          # sub, average, paeth
            cur, up = line.tolist(), prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    p = a
                elif ftype == 3:
                    p = (a + up[x]) >> 1
                else:
                    b = up[x]
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + p) & 0xFF
            cur = np.array(cur, np.int32)
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = cur
        prev = cur
    return out


def read_png(path) -> np.ndarray:
    """Decode a non-interlaced 8- or 16-bit grey/RGB(A) PNG file: (H, W) or
    (H, W, C), uint8 or uint16."""
    return decode_png(Path(path).read_bytes(), str(path))


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``read_png`` of the file's bytes."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        length, = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = hdr
    if depth not in (8, 16) or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        img = rows.reshape(h, w * ch, 2).astype(np.uint16)
        img = (img[..., 0] << 8) | img[..., 1]
    else:
        img = rows
    return img.reshape(h, w, ch)[..., 0] if ch == 1 else img.reshape(h, w, ch)


def gray(bgr: np.ndarray) -> np.ndarray:
    """OpenCV's COLOR_BGR2GRAY for uint8 (OpenCV 5's fixed point, equal to
    it on all 2^24 colours): Y = (3735 B + 19235 G + 9798 R + 2^14) >> 15.
    OpenCV 4's 14-bit weights (1868, 9617, 4899) differ on ~0.1% of
    colours."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((3735 * b + 19235 * g + 9798 * r + 16384) >> 15).astype(np.uint8)


class ReplicaScene:
    """One scene directory; frames are read on demand."""

    def __init__(self, scene_dir):
        self.dir = Path(scene_dir)
        lines = (self.dir / "camera.txt").read_text().split("\n")
        parts = lines[0].split()
        if parts[0].lower() == "pinhole":
            parts = parts[1:]
        self.fx, self.fy, self.cx, self.cy = (float(x) for x in parts[:4])
        self.width, self.height = (int(x) for x in lines[1].split()[:2])
        self.K = np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                           [0, 0, 1]], np.float32)
        self.poses = {}
        for ln in (self.dir / "poses_gt.txt").read_text().splitlines():
            if ln.strip():
                vals = ln.split()
                self.poses[int(vals[0])] = np.array(
                    vals[1:17], np.float64).reshape(4, 4)
        self.depth_scale = float(
            (self.dir / "depths" / "scale.txt").read_text().split()[0])
        self.windows = []
        win = self.dir / "tuples_dso_optimization_windows.txt"
        if win.exists():
            for ln in win.read_text().splitlines():
                vals = ln.split()
                if vals:
                    n = int(vals[0])
                    self.windows.append([int(v) for v in vals[1:1 + n]])

    def bgr(self, i: int) -> np.ndarray:
        """(H, W, 3) uint8 BGR, as cv2.imread returns it."""
        return np.ascontiguousarray(
            read_png(self.dir / "images" / f"{i:06d}.png")[..., ::-1])

    def gray(self, i: int) -> np.ndarray:
        """(H, W) float32 grey intensity in [0, 255]."""
        return gray(self.bgr(i)).astype(np.float32)

    def depth(self, i: int) -> np.ndarray:
        """(H, W) float32 metres, 0 = invalid."""
        raw = read_png(self.dir / "depths" / f"{i:06d}.png")
        return (raw.astype(np.float64) * self.depth_scale).astype(np.float32)

    def c2w(self, i: int) -> np.ndarray:
        return self.poses[i].astype(np.float32)
