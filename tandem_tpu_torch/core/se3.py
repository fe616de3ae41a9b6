"""SE(3)/SO(3) Lie-group operations on (..., 4, 4) tensors.

Port of ``tandem_tpu/core/se3.py`` (the reference's Sophus usage,
tandem/src/util/NumType.h). Batched and safe at the small-angle limit: the
Taylor branches and their switches (theta^2 < 1e-5, the _EPS floor under
the square root) are the JAX package's. Matrix products run in full f32
(the JAX package asks for Precision.HIGHEST); on the card that needs TF32
off, which ``pin_f32_precision()`` sets.
"""

from __future__ import annotations

import torch

# Small-angle switch: in float32, 1-cos(theta) and 1-A/(2B) cancel
# catastrophically below theta ~ 3e-3; the Taylor branches are more
# accurate there.
_EPS = 1e-8


def _hat(w):
    """so(3) hat operator. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _coeffs(theta2):
    """A = sin(theta)/theta and B = (1-cos(theta))/theta^2 with their
    Taylor branches below theta^2 = 1e-5."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-5
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    return small, A, B


def _eye3(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w):
    """Rodrigues formula with Taylor fallback. w: (..., 3) -> (..., 3, 3)."""
    _, A, B = _coeffs(torch.sum(w * w, dim=-1))
    W = _hat(w)
    return _eye3(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R):
    """Inverse of so3_exp. R: (..., 3, 3) -> (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    theta2 = theta * theta
    small = theta2 < 1e-5
    # w_hat = theta / (2 sin(theta)) * (R - R^T)
    factor = torch.where(
        small, 0.5 + theta2 / 12.0,
        theta / (2.0 * torch.sin(torch.where(small, torch.ones_like(theta),
                                             theta))))
    skew = (R - R.transpose(-1, -2)) * factor[..., None, None]
    return torch.stack([skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]],
                       -1)


def _bottom_row(top):
    row = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype,
                       device=top.device)
    return torch.cat([top, row.expand(top.shape[:-2] + (1, 4))], -2)


def se3_exp(xi):
    """se(3) exponential. xi = (..., 6) with (v, w) ordering: translation
    first (DSO's [trans, rot] increment order). Returns (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    small, A, B = _coeffs(theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2)
    W = _hat(w)
    I = _eye3(W)
    WW = W @ W
    R = I + A[..., None, None] * W + B[..., None, None] * WW
    V = I + B[..., None, None] * W + C[..., None, None] * WW
    t = (V @ v[..., None])[..., 0]
    return _bottom_row(torch.cat([R, t[..., None]], -1))


def se3_log(T):
    """Inverse of se3_exp. T: (..., 4, 4) -> (..., 6) with (v, w) order."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    small, A, B = _coeffs(theta2)
    # V^{-1} = I - 1/2 W + (1/theta2)(1 - A/(2B)) W^2
    D = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - A / (2.0 * B)) / torch.clamp(theta2, min=_EPS))
    W = _hat(w)
    Vinv = _eye3(W) - 0.5 * W + D[..., None, None] * (W @ W)
    v = (Vinv @ t[..., None])[..., 0]
    return torch.cat([v, w], -1)


def se3_inverse(T):
    """(..., 4, 4) rigid-transform inverse without a general solve."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _bottom_row(torch.cat([Rt, -(Rt @ T[..., :3, 3:])], -1))


def se3_compose(A, B):
    return A @ B


def se3_identity(dtype=torch.float32, device=None):
    return torch.eye(4, dtype=dtype, device=device)
