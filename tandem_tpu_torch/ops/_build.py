"""Build and load the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` file is compiled with nvcc for Hopper (sm_90a) into one
shared library with a plain C interface, loaded with ctypes. The library
lands in ``tandem_tpu_torch/_build/<hash>/``, keyed by a hash of the sources
and flags, at first use: nothing is built when a module is imported, and no
binary is committed.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_c_int, _c_ptr = ctypes.c_int, ctypes.c_void_p
# Exported C entry points: name -> argtypes (every one returns a CUDA error
# code as int).
SIGNATURES = {
    "tandem_edge_kth": [_c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_ptr],
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


def library_path() -> Path:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
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
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC_DIR.glob("*.cu")))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
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
