"""Small fixed-size linear algebra.

Port of ``tandem_tpu/ops/linalg.py``: the closed-form inverse of the
plane-sweep's pixel projection, and the unrolled Gauss-Jordan and Cholesky
solves of the tracker's LM steps. The JAX package wrote them unrolled to
stay off XLA's LU custom calls; here they are kept as written so that the
arithmetic, and with it every LM accept decision, is the JAX package's.
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


def _gauss_jordan(M, n: int):
    """n pivot steps of vector row operations on M (..., n, m), unpivoted
    (the systems are SPD and damped); the pivot is floored at 1e-30 in
    magnitude as in the JAX package."""
    M = M.clone()
    for j in range(n):
        pivot = M[..., j, j]
        safe = torch.where(pivot.abs() > 1e-30, pivot,
                           torch.full_like(pivot, 1e-30))
        row_j = M[..., j, :] / safe[..., None]
        factors = M[..., :, j].clone()
        factors[..., j] = 0.0
        M = M - factors[..., :, None] * row_j[..., None, :]
        M[..., j, :] = row_j
    return M


def solve_gauss_jordan(A, b, n: int):
    """Solve A x = b, A (n, n), b (n,), by unpivoted Gauss-Jordan
    elimination with vector row operations (port of the JAX package's, not
    ``torch.linalg.solve``: the LM accept test compares energies, so the
    step must be the same step)."""
    return _gauss_jordan(torch.cat([A, b[:, None]], 1), n)[:, n]


def solve_gauss_jordan_batched(A, b, n: int):
    """Batched Gauss-Jordan solve: A (B, n, n), b (B, n) -> (B, n)."""
    return _gauss_jordan(torch.cat([A, b[..., None]], -1), n)[..., n]


def cholesky_small(A, n: int):
    """Unrolled Cholesky factor of an (n, n) SPD matrix (small static n)."""
    L = torch.zeros_like(A)
    for j in range(n):
        s = A[j, j] - torch.sum(L[j, :j] ** 2) if j > 0 else A[j, j]
        d = torch.sqrt(torch.clamp(s, min=1e-20))
        L[j, j] = d
        if j + 1 < n:
            off = (A[j + 1:, j] - L[j + 1:, :j] @ L[j, :j] if j > 0
                   else A[j + 1:, j])
            L[j + 1:, j] = off / d
    return L


def solve_psd(A, b):
    """Solve A x = b for SPD A via the unrolled Cholesky. A: (n, n),
    b: (n,)."""
    n = A.shape[0]
    L = cholesky_small(A, n)
    y = torch.zeros_like(b)
    for i in range(n):                                   # L y = b
        acc = b[i] - (L[i, :i] @ y[:i] if i > 0 else 0.0)
        y[i] = acc / L[i, i]
    x = torch.zeros_like(b)
    for i in range(n - 1, -1, -1):                       # L^T x = y
        acc = y[i] - (L[i + 1:, i] @ x[i + 1:] if i + 1 < n else 0.0)
        x[i] = acc / L[i, i]
    return x


def inv_psd_small(A, n: int):
    """Inverse of a small SPD matrix by Gauss-Jordan on [A | I]."""
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return _gauss_jordan(torch.cat([A, eye], 1), n)[:, n:]
