"""Small constant tensors made once per device.

``torch.tensor(value, device="cuda")`` copies from pageable host memory,
which waits for the stream: inside a per-frame loop every such constant is
a host read's worth of stall. ``const`` keeps one tensor per (value,
device, dtype); callers must not modify it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def const(value, device, dtype=torch.float32) -> torch.Tensor:
    """A tensor of ``value`` (a number or a nested tuple) on ``device``."""
    return torch.tensor(value, dtype=dtype, device=device)


def upload(array, device, dtype=np.float32) -> torch.Tensor:
    """A numpy array as ``dtype`` on ``device``; on the card through pinned
    memory without waiting for the stream (on the CPU the tensor shares the
    array's memory)."""
    t = torch.from_numpy(np.ascontiguousarray(array, dtype))
    if torch.device(device).type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def reciprocal32(x: float) -> float:
    """The float32 reciprocal of a constant, as a Python float. XLA compiles
    the JAX package's division by a constant as a product with it (and
    CUDA a ``tensor / float``), so the port multiplies by it where the
    JAX package divides by a constant."""
    return float(np.float32(1) / np.float32(x))
