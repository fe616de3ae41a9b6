"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled with nvcc for Hopper (sm_90a), one nvcc
process per source, all started together (``csrc/*.cuh`` are headers they
include); the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The library lands in
``tandem_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and
flags, at first use: nothing is built when a module is imported, and no
binary is committed. ptxas's register and spill report of the build is
kept beside the library as ``ptxas.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_c_int, _c_i64, _c_ptr = ctypes.c_int, ctypes.c_int64, ctypes.c_void_p
_c_f32 = ctypes.c_float
_TRACK_LEVEL = ([_c_ptr, _c_ptr, _c_int] + [_c_ptr] * 8 + [_c_i64, _c_int, _c_int]
                + [_c_f32] * 6 + [_c_int])
# Exported C entry points: name -> argtypes (every one returns a CUDA error
# code as int and takes the stream last).
SIGNATURES = {
    "tandem_edge_kth": [_c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr],
    "tandem_bilinear_index": [_c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i64, _c_int,
                              _c_int, _c_ptr, _c_ptr, _c_int, _c_ptr],
    "tandem_corner_blend": [_c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i64, _c_int,
                            _c_int, _c_int, _c_ptr, _c_ptr],
    "tandem_row_gather": [_c_ptr, _c_ptr, _c_i64, _c_i64, _c_i64, _c_int,
                          _c_ptr, _c_ptr],
    # one packed argument block (bytes) and the stream
    "tandem_warp_sample": [ctypes.c_char_p, _c_ptr],
    "tandem_bilinear_sample": [ctypes.c_char_p, _c_ptr],
    "tandem_warp_sample_grad": [ctypes.c_char_p, _c_ptr],
    "tandem_warp_variance": [ctypes.c_char_p, _c_ptr],
    "tandem_tsdf_integrate": [ctypes.c_char_p, _c_ptr],
    "tandem_tsdf_splat": [ctypes.c_char_p, _c_ptr],
    "tandem_tsdf_fill_holes": [ctypes.c_char_p, _c_ptr],
    "tandem_deconv_bn_relu_add": [ctypes.c_char_p, _c_ptr],
    # ... and an int it sets to the number of kernels it launched
    "tandem_edge_filter": [ctypes.c_char_p, ctypes.POINTER(_c_int), _c_ptr],
    # T, aff, B, then the level (ops/track_reduce.level_args)
    "tandem_track_reduce": _TRACK_LEVEL + [_c_ptr] * 4 + [_c_ptr],
    "tandem_track_lm": _TRACK_LEVEL + [_c_ptr] + [_c_int] * 3
                       + [_c_ptr] * 3 + [_c_ptr],
}


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of tandem_tpu_torch "
                       "need the CUDA toolkit (set CUDA_HOME)")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):      # sources and headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libtandem_kernels.so"


def build() -> float:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    Returns the seconds spent compiling (0.0 when it was already built)."""
    out = library_path()
    if out.exists():
        return 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in _sources():
        obj = out.parent / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed, report = [], []
    for cmd, _, proc in jobs:
        stdout, stderr = proc.communicate()
        report.append(stderr)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{tag}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{' '.join(link)}\n{res.stdout}\n{res.stderr}")
    (out.parent / "ptxas.log").write_text("".join(report))
    os.replace(tmp, out)
    for _, obj, _ in jobs:
        obj.unlink()
    return time.perf_counter() - t0


@functools.cache
def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` on ``device``'s current
    stream (appended as the last argument); raise if the launch failed.

    A launch goes to the calling thread's current device, so ``device`` is
    made current around the call when it is not already. The stream comes
    from torch's raw-handle lookup where it has one (a few µs less per
    launch than building a ``torch.cuda.Stream``)."""
    import torch
    fn = getattr(kernels(), name)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = _raw_stream()(index)
    if index == current:
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def current_stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream (the stream
    ``launch`` passes)."""
    import torch
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return _raw_stream()(index)


@functools.cache
def _raw_stream():
    """device index -> the raw handle of its current CUDA stream."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw or (lambda index: torch.cuda.current_stream(index).cuda_stream)
