"""The PNG container and OpenCV's colour read, shared by the plain decoder
(``data/replica.decode_png``) and the C one
(``native_bridge.decode_png_native``)."""

from __future__ import annotations

import struct

import numpy as np

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG colour type -> samples per pixel


def png_layout(data: bytes, path: str = "<bytes>"):
    """A PNG file's (height, width, bit depth, samples a pixel, compressed
    image data of all its IDAT chunks)."""
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
    return h, w, depth, _CHANNELS[ctype], b"".join(idat)


def bgr8(img: np.ndarray) -> np.ndarray:
    """A decoded PNG as cv2.imread(IMREAD_COLOR) returns it: 3-channel
    uint8 BGR (grey replicated, alpha dropped, 16 bits cut to 8)."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    if img.shape[2] == 2:                      # grey + alpha
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., 2::-1])
