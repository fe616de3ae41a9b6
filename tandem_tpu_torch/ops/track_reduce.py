"""Kernel K6: the coarse tracker's residuals and normal equations.

``track_reduce`` launches the hand-written CUDA kernel
``csrc/track_reduce.cu`` for CUDA tensors and uses ``track_reduce_plain``
for CPU tensors; a CUDA tensor never reaches the plain version (there is no
fallback: the kernel runs or the call raises). Both compute
``_energy_and_system(tdist=False)`` of ``tandem_tpu/tracking/
coarse_tracker.py``: for every candidate pose b and reference point n,
project the point into the new frame, sample intensity and gradients
bilinearly, form the photometric residual, its Huber/cutoff weight and its
8-vector Jacobian, and sum the energy, the count of usable residuals and
H = J^T W J, g = J^T W r.

The JAX package samples a 12-wide corner-packed table (``_pack_level``, a
TPU gather trick); here both versions read the three level planes
(intensity, gx, gy) directly. The plain version writes the projection, the
border test, the bilinear sample and the residual as the same sequence of
f32 operations as the kernel, which evaluates them with round-to-nearest
intrinsics (no FMA contraction): on the same inputs both keep the same
points, so ``num`` is equal and only the order of the sums differs.
"""

from __future__ import annotations

import torch

CUTOFF_TH = 20.0                       # setting_coarseCutoffTH
HUBER_TH = 9.0                         # setting_huberTH
N_ACC = 46                             # energy, num, 36 of H, 8 of g
POINTS_PER_BLOCK = 1024                # csrc/track_reduce.cu kPointsPerBlock


def bilinear_with_grad(img, gx, gy, x, y):
    """Sample intensity and gradients of (H, W) planes at float pixel
    coordinates x, y of any shape. Indices are clipped to the image; the
    callers mask samples near the border, so clipping never changes a used
    value."""
    H, W = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.to(torch.int32).clamp(0, W - 2).long()
    y0i = y0.to(torch.int32).clamp(0, H - 2).long()
    i00 = (y0i * W + x0i).reshape(-1)
    w00 = (1 - wx) * (1 - wy)
    w01 = wx * (1 - wy)
    w10 = (1 - wx) * wy
    w11 = wx * wy

    def sample(plane):
        p = plane.reshape(-1)
        v = (p[i00].reshape(x.shape) * w00 + p[i00 + 1].reshape(x.shape) * w01
             + p[i00 + W].reshape(x.shape) * w10
             + p[i00 + W + 1].reshape(x.shape) * w11)
        return v

    return sample(img), sample(gx), sample(gy)


def level_residuals(T, aff, pts, planes, Klvl):
    """Residuals and Jacobians of one level's point list, batched over B
    candidate poses (``_level_residuals`` of the JAX package).

    :param T: (B, 4, 4); aff: (B, 2)
    :param pts: (pu, pv, pid, pcolor, pvalid), each (N,)
    :param planes: (img, gx, gy) of the new frame's level, each (H, W)
    :param Klvl: (fx, fy, cx, cy) floats
    :return: r (B, N), J (B, N, 8), good (B, N), px, py (B, N)
    """
    pu, pv, idv, ref_c, msk = pts
    img, gx, gy = planes
    H, W = img.shape
    fx, fy, cx, cy = Klvl
    un = (pu - cx) / fx
    vn = (pv - cy) / fy
    R = T[:, :3, :3]
    t = T[:, :3, 3]

    def row(i):   # R[i] . (un, vn, 1) + t_i * id, summed left to right
        return (R[:, i, 0:1] * un + R[:, i, 1:2] * vn + R[:, i, 2:3]
                + t[:, i:i + 1] * idv)

    q0, q1, qz = row(0), row(1), row(2)
    good = msk[None] & (qz > 1e-6)
    qz_safe = torch.where(qz > 1e-6, qz, torch.ones_like(qz))
    u2 = q0 / qz_safe
    v2 = q1 / qz_safe
    px = fx * u2 + cx
    py = fy * v2 + cy
    good = good & (px > 2) & (px < W - 3) & (py > 2) & (py < H - 3)

    hit, gx_i, gy_i = bilinear_with_grad(img, gx, gy, px, py)
    a = aff[:, 0:1]
    b = aff[:, 1:2]
    r = hit - (a * ref_c + b)

    idn = idv / qz_safe
    dxf = gx_i * fx
    dyf = gy_i * fy
    refc = ref_c.expand(r.shape)
    J = torch.stack([
        idn * dxf,
        idn * dyf,
        -idn * (u2 * dxf + v2 * dyf),
        -(u2 * v2 * dxf + (1 + v2 * v2) * dyf),
        (1 + u2 * u2) * dxf + u2 * v2 * dyf,
        u2 * dyf - v2 * dxf,
        -refc,
        -torch.ones_like(refc),
    ], -1)
    return r, J, good, px, py


def normal_equations(r, J, wf):
    """H = J^T diag(w) J (B, 8, 8) and g = J^T diag(w) r (B, 8)."""
    Jw = J * wf[..., None]
    return (torch.einsum("bni,bnj->bij", Jw, J),
            torch.einsum("bni,bn->bi", Jw, r))


def track_reduce_plain(T, aff, pts, planes, Klvl):
    """Plain PyTorch K6: (energy (B,), num (B,), Hm (B, 8, 8), g (B, 8)) of
    the Huber + cutoff branch, in the dtype of the inputs."""
    r, J, good, _, _ = level_residuals(T, aff, pts, planes, Klvl)
    absr = r.abs()
    use = good & (absr < CUTOFF_TH)
    hw = torch.where(absr < HUBER_TH, torch.ones_like(r),
                     HUBER_TH / torch.clamp(absr, min=1e-12))
    # DSO energy form: hw * r^2 * (2 - hw); saturated residuals add the max
    zero = torch.zeros_like(r)
    e_pix = torch.where(use, hw * r * r * (2.0 - hw),
                        torch.where(good, torch.full_like(r, CUTOFF_TH ** 2),
                                    zero))
    wf = torch.where(use, hw, zero)
    Hm, g = normal_equations(r, J, wf)
    return e_pix.sum(-1), good.to(r.dtype).sum(-1), Hm, g


def _check(T, aff, pts, planes):
    dev = T.device
    B = T.shape[0]
    N = pts[0].shape[0]
    H, W = planes[0].shape
    for name, t, shape, dtype in (
            ("T", T, (B, 4, 4), torch.float32),
            ("aff", aff, (B, 2), torch.float32),
            ("pu", pts[0], (N,), torch.float32),
            ("pv", pts[1], (N,), torch.float32),
            ("pid", pts[2], (N,), torch.float32),
            ("pcolor", pts[3], (N,), torch.float32),
            ("pvalid", pts[4], (N,), torch.bool),
            ("img", planes[0], (H, W), torch.float32),
            ("gx", planes[1], (H, W), torch.float32),
            ("gy", planes[2], (H, W), torch.float32)):
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"track_reduce: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {dev}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def track_reduce(T, aff, pts, planes, Klvl):
    """K6 on the card (CUDA tensors) or its plain version (CPU tensors).

    :param T: (B, 4, 4) f32 candidate ref->new poses; aff: (B, 2) f32
    :param pts: (pu, pv, pid, pcolor) (N,) f32 and pvalid (N,) bool
    :param planes: (img, gx, gy) (H, W) f32 of the new frame's level
    :param Klvl: (fx, fy, cx, cy) floats
    :return: energy (B,), num (B,), Hm (B, 8, 8), g (B, 8), f32
    """
    if T.device.type == "cpu":
        return track_reduce_plain(T, aff, pts, planes, Klvl)
    if T.device.type != "cuda":
        raise ValueError(f"track_reduce: unsupported device {T.device}")
    _check(T, aff, pts, planes)
    from ._build import launch

    B, N = T.shape[0], pts[0].shape[0]
    H, W = planes[0].shape
    dev = T.device
    nblk = max(-(-N // POINTS_PER_BLOCK), 1)
    partial = torch.empty((B, nblk, N_ACC), dtype=torch.float32, device=dev)
    energy = torch.empty(B, dtype=torch.float32, device=dev)
    num = torch.empty(B, dtype=torch.float32, device=dev)
    Hm = torch.empty((B, 8, 8), dtype=torch.float32, device=dev)
    g = torch.empty((B, 8), dtype=torch.float32, device=dev)
    launch("tandem_track_reduce", dev,
           *(p.data_ptr() for p in pts), T.data_ptr(), aff.data_ptr(),
           *(p.data_ptr() for p in planes), N, B, H, W,
           *(float(k) for k in Klvl), CUTOFF_TH, HUBER_TH,
           partial.data_ptr(), nblk, energy.data_ptr(), num.data_ptr(),
           Hm.data_ptr(), g.data_ptr())
    track_reduce.launches += 1
    return energy, num, Hm, g


track_reduce.launches = 0
