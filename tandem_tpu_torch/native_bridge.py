"""The port's host image library: PNG decode, undistortion remap, BGR
repacks and a prefetching image loader.

Counterpart of ``tandem_tpu/native_bridge.py``. ``csrc/host_image.c`` is
plain C built with the host compiler (``cc -O3 -shared -fPIC``) into
``tandem_tpu_torch/_build/<hash>/libtandem_host.so`` at first use, keyed by
a hash of the source and flags, and called through ctypes (which releases
the GIL for the call). It is a library of its own beside the CUDA kernels'
``libtandem_kernels.so``: it needs no nvcc, so the CPU tests build and run
the real C code. A PNG is inflated by Python's ``zlib`` (its C core
releases the GIL too) and unfiltered in C; ``decode_png_native`` equals
``data/replica.decode_png`` bit for bit. There is no fallback: when the
library cannot be built, a call raises.

``PrefetchImageLoader`` is the JAX package's native loader
(native/tandem_native.cpp:267-356) on a Python thread: a worker decodes
up to ``ahead`` frames past the consumer, a read blocks until its frame is
ready, a forward skip seeks the worker forward, and a backward read of a
spent frame decodes synchronously.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import weakref
import zlib
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from .data.png_format import bgr8, png_layout

PKG_DIR = Path(__file__).resolve().parent
SOURCE = PKG_DIR / "csrc" / "host_image.c"
BUILD_DIR = PKG_DIR / "_build"
CC_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c99", "-ffp-contract=off"]

_c_int, _c_i64, _c_ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
# Exported C functions: name -> (argtypes, restype).
SIGNATURES = {
    "tandem_png_unfilter": ([_c_ptr, _c_int, _c_i64, _c_int, _c_ptr], _c_int),
    "tandem_remap_u8": ([_c_ptr, _c_int, _c_int, _c_int, _c_ptr, _c_ptr,
                         _c_int, _c_int, _c_ptr, _c_ptr], None),
    "tandem_bgr_to_rgb_chw": ([_c_ptr, _c_int, _c_int, _c_ptr], None),
    "tandem_bgr_pack_u8": ([_c_ptr, _c_int, _c_int, _c_int, _c_ptr], None),
}


def _compiler() -> str:
    for c in (os.environ.get("CC"), "cc", "gcc"):
        if c and shutil.which(c):
            return shutil.which(c)
    raise RuntimeError("no C compiler (cc) found: tandem_tpu_torch's host "
                       "image library (csrc/host_image.c) needs one")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CC_FLAGS).encode() + SOURCE.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libtandem_host.so"


def build() -> Path:
    """Compile ``csrc/host_image.c`` unless its library exists; raise with
    the compiler's output when it fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), *CC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"host library build failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)      # atomic: concurrent builders agree
    return out


@functools.cache
def get_lib() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def decode_png_native(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """``data/replica.decode_png`` with the row unfilter in C."""
    h, w, depth, ch, compressed = png_layout(data, path)
    bpp = ch * depth // 8
    stride = w * bpp
    raw = zlib.decompress(compressed)
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: PNG data ends early ({len(raw)} bytes "
                         f"for {h} rows of {stride + 1})")
    rows = np.empty((h, stride), np.uint8)
    bad = get_lib().tandem_png_unfilter(raw, h, stride, bpp, _ptr(rows))
    if bad:
        ftype = raw[(bad - 1) * (stride + 1)]
        raise ValueError(f"PNG: unknown row filter {ftype}")
    img = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    return img.reshape(h, w, ch)[..., 0] if ch == 1 else img.reshape(h, w, ch)


def read_png_native(path) -> np.ndarray:
    """``data/replica.read_png`` through the C decoder."""
    return decode_png_native(Path(path).read_bytes(), str(path))


def read_bgr8(path) -> np.ndarray:
    """A PNG file as cv2.imread(IMREAD_COLOR) returns it: (H, W, 3) uint8
    BGR."""
    return bgr8(read_png_native(path))


def remap_u8(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray,
             lut256: Optional[np.ndarray] = None) -> np.ndarray:
    """``data/undistort.remap_u8`` in C (float64, equal bit for bit), with
    the optional 256-entry inverse-response LUT of the JAX package's
    ``remap_u8``."""
    c = 1 if src.ndim == 2 else src.shape[2]
    src = np.ascontiguousarray(src, np.uint8)
    mx = np.ascontiguousarray(map_x, np.float32)
    my = np.ascontiguousarray(map_y, np.float32)
    if mx.shape != my.shape or src.shape[0] < 2 or src.shape[1] < 2:
        raise ValueError(f"remap_u8: maps {mx.shape} / {my.shape} of a "
                         f"{src.shape} image")
    out_h, out_w = mx.shape
    dst = np.empty((out_h, out_w, c), np.float64)
    lut = None
    if lut256 is not None:
        lut = np.ascontiguousarray(lut256, np.float32)
        if lut.shape != (256,):
            raise ValueError(f"remap_u8: LUT of shape {lut.shape}")
    get_lib().tandem_remap_u8(_ptr(src), src.shape[1], src.shape[0], c,
                              _ptr(mx), _ptr(my), out_w, out_h,
                              None if lut is None else _ptr(lut), _ptr(dst))
    return dst[..., 0] if c == 1 else dst


def bgr_pack_u8(bgrs: Sequence[np.ndarray]) -> np.ndarray:
    """V uint8 BGR (H, W, 3) views -> one (V, 3, H, W) RGB uint8 array, the
    MVSNet runner's input layout."""
    views = [np.ascontiguousarray(b, np.uint8) for b in bgrs]
    h, w = views[0].shape[:2]
    if any(v.shape != (h, w, 3) for v in views):
        raise ValueError("bgr_pack_u8: views of different shapes "
                         f"{[v.shape for v in views]}")
    out = np.empty((len(views), 3, h, w), np.uint8)
    ptrs = (ctypes.c_void_p * len(views))(*(_ptr(v) for v in views))
    get_lib().tandem_bgr_pack_u8(ptrs, len(views), w, h, _ptr(out))
    return out


def bgr_to_rgb_chw(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (3, H, W) float32 RGB / 255."""
    bgr = np.ascontiguousarray(bgr, np.uint8)
    h, w = bgr.shape[:2]
    if bgr.shape != (h, w, 3):
        raise ValueError(f"bgr_to_rgb_chw: {bgr.shape}")
    out = np.empty((3, h, w), np.float32)
    get_lib().tandem_bgr_to_rgb_chw(_ptr(bgr), w, h, _ptr(out))
    return out


class _LoaderState:
    """What the worker thread shares with the loader; the worker holds this
    and not the loader, so a dropped loader is collected and its finalizer
    stops the worker."""

    def __init__(self, paths: List[str], ahead: int):
        self.paths = paths
        self.ahead = max(int(ahead), 1)
        self.cv = threading.Condition()
        self.cache: dict = {}       # idx -> BGR frame decoded ahead
        self.failed: dict = {}      # idx -> the decode's exception
        self.consumer = 0           # the newest frame asked for
        self.decoded_next = 0       # the worker's forward watermark
        self.stop = False


def _prefetch_worker(st: _LoaderState):
    nxt, n = 0, len(st.paths)
    while True:
        with st.cv:
            st.cv.wait_for(lambda: st.stop or (
                nxt < n and nxt <= st.consumer + st.ahead))
            if st.stop:
                return
            nxt = max(nxt, st.consumer)              # seek forward
        try:
            frame, err = read_bgr8(st.paths[nxt]), None
        except Exception as e:      # handed to the read of this frame
            frame, err = None, e
        with st.cv:
            if err is None:
                st.cache[nxt] = frame
            else:
                st.failed[nxt] = err
            st.decoded_next = nxt + 1
            st.cv.notify_all()
        nxt += 1


def _stop_worker(st: _LoaderState, thread: threading.Thread):
    with st.cv:
        st.stop = True
        st.cv.notify_all()
    if thread is not threading.current_thread():
        thread.join()


class PrefetchImageLoader:
    """Decodes PNG frames ahead of the consumer on a worker thread; reads
    return BGR uint8 (H, W, 3) as cv2.imread(IMREAD_COLOR) does."""

    def __init__(self, paths: Sequence[str], ahead: int = 8):
        get_lib()                   # build in the caller, not the worker
        self.paths = [str(p) for p in paths]
        self._st = _LoaderState(self.paths, ahead)
        self._thread = threading.Thread(target=_prefetch_worker,
                                        args=(self._st,), daemon=True,
                                        name="tandem-prefetch")
        self._thread.start()
        # Stops the worker on close(), on collection and at exit.
        self._finalizer = weakref.finalize(self, _stop_worker, self._st,
                                           self._thread)

    def read(self, idx: int) -> np.ndarray:
        """Frame ``idx``: waits for the worker unless the frame is behind
        it, which is then decoded here."""
        st = self._st
        if not 0 <= idx < len(self.paths):
            raise IndexError(f"frame {idx} of {len(self.paths)}")
        with st.cv:
            if st.stop:
                raise RuntimeError("PrefetchImageLoader is closed")
            if idx > st.consumer:
                st.consumer = idx                    # advance the window
                st.cv.notify_all()
            st.cv.wait_for(lambda: st.stop or idx in st.cache
                           or idx in st.failed or idx < st.decoded_next)
            if idx in st.failed:
                raise st.failed.pop(idx)
            frame = st.cache.get(idx)
            if frame is not None:
                # Frames at or before the one read are spent.
                for k in [k for k in st.cache if k <= idx]:
                    del st.cache[k]
                st.cv.notify_all()
                return frame
            if st.stop:
                raise RuntimeError("PrefetchImageLoader is closed")
        return read_bgr8(self.paths[idx])            # behind the worker

    def close(self):
        """Stop the worker and join it."""
        self._finalizer()
