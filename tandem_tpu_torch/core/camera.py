"""Per-stage intrinsics of the runtime path (copy of tandem_tpu.core.camera's
numpy helpers; the port cannot import the JAX package).

The C++ runtime naively multiplies the first two rows of K by 0.25/0.5
(dr_mvsnet.cpp:226-247 skips the +0.5 half-pixel correction); the runner
replicates that for parity with the deployed model.
"""

from __future__ import annotations

import numpy as np


def scale_K_naive(K: np.ndarray, scale: float) -> np.ndarray:
    """Naive first-two-rows scaling (the runtime C++ behaviour,
    dr_mvsnet.cpp:226-247)."""
    K = np.array(K, copy=True)
    K[..., :2, :] = K[..., :2, :] * scale
    return K


def stage_intrinsics_runtime(K: np.ndarray):
    """Per-stage intrinsics for stages (1, 2, 3) using the runtime's naive
    0.25x/0.5x scaling (replicates dr_mvsnet.cpp behaviour)."""
    return scale_K_naive(K, 0.25), scale_K_naive(K, 0.5), np.array(K, copy=True)
