"""Closed-form inverse of the plane-sweep's pixel projection.

Port of ``invert_pixel_projection`` from ``tandem_tpu/ops/linalg.py``. The
closed form keeps the warp's arithmetic identical to the JAX package's, so
the parity tests compare like with like.
"""

from __future__ import annotations

import torch


def inv3x3(A):
    """Closed-form 3x3 inverse via the adjugate. A: (..., 3, 3)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    row0 = torch.stack([co_a, -(b * i - c * h), b * f - c * e], -1)
    row1 = torch.stack([co_b, a * i - c * g, -(a * f - c * d)], -1)
    row2 = torch.stack([co_c, -(a * h - b * g), a * e - b * d], -1)
    return torch.stack([row0, row1, row2], -2) * (1.0 / det)[..., None, None]


def invert_pixel_projection(K, cam_to_world):
    """Inverse of the 4x4 world->pixel matrix [[K (R|t)], [0 0 0 1]] where
    (R|t) = inverse(cam_to_world): cam_to_world @ diag(K^-1, 1).

    K: (..., 3, 3); cam_to_world: (..., 4, 4) -> (..., 4, 4)
    """
    top = cam_to_world[..., :3, :3] @ inv3x3(K)
    upper = torch.cat([top, cam_to_world[..., :3, 3:]], -1)
    return torch.cat([upper, cam_to_world[..., 3:4, :]], -2)
