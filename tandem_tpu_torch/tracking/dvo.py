"""dvo-core DenseTracker: bivariate (intensity + depth) RGB-D alignment.

Port of ``tandem_tpu/tracking/dvo.py`` (the reference's vendored Dense
Visual Odometry tracker, tandem/src/dvo-core/, which it runs in RGB-D mode
on pyramid level 1, CoarseTracker::trackNewestCoarseDense):

- per-level IRLS loop (DenseTracker::match, dense_tracking.cpp:132-424):
  warp the reference points, bivariate residual r = [r_I, r_Z], bivariate
  Student-t scale and weights (nu = 5), the 2x6 Jacobian at the reference
  point, LM damping with the log-likelihood accept/revert;
- the residual (computeResiduals, dense_tracking_impl.cpp:36-121): the
  six planes [I, Z, Idx, Idy, Zdx, Zdy] of the current frame sampled
  bilinearly at the projected reference points, the affine light model
  a I_ref + b, r_Z = Z_cur(warped) - z of the transformed point, the
  occlusion gate r_Z > -20 sigma_z(Z_ref);
- the pyramid (rgbd_image.cpp): intensity 2x2 mean, depth 2x2 subsample,
  central-difference derivatives with clamped borders, K x 0.5 a level.

The arithmetic is the JAX package's, in its order; so are its documented
deviations from the reference (every log-likelihood term is summed; each
level restarts from log(T)). Two differences, neither in the arithmetic:
the current frame's planes are sampled directly (the JAX package's 24-wide
corner pack is a TPU gather layout; the corner weights and their order are
the same), and the level's ``lax.while_loop`` is ``max_iterations`` masked
iterations on the device: once the loop's condition is false the carry
stays as it was, so there is no host read inside a level.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.se3 import se3_exp, se3_log
from ..ops.linalg import solve_gauss_jordan
from ..utils.consts import const, reciprocal32

NU = 5.0          # TDistribution DEFAULT_DOF (weight_calculation.h)


class DvoConfig(NamedTuple):
    """DenseTracker::Config (dense_tracking_config.cpp:27-42 defaults)."""
    first_level: int = 3
    last_level: int = 1
    max_iterations: int = 5
    precision: float = 1e-4
    mu: float = 0.0
    intensity_derivative_threshold: float = 0.0
    depth_derivative_threshold: float = 0.0


class RgbdLevel(NamedTuple):
    """One pyramid level. ``planes`` stacks the six sampled channels
    [I, Z, Idx, Idy, Zdx, Zdy] per pixel, (H, W, 6)."""
    intensity: torch.Tensor     # (H, W) float 0..255
    depth: torch.Tensor         # (H, W) metres (<= 0 or nan = invalid)
    idx: torch.Tensor           # (H, W) dI/dx (central diff * 0.5)
    idy: torch.Tensor
    zdx: torch.Tensor
    zdy: torch.Tensor
    planes: torch.Tensor        # (H, W, 6)
    K: Tuple[float, float, float, float]   # fx, fy, cx, cy at this level


def _central_diff(img, axis: int):
    """(img[next] - img[prev]) * 0.5 with clamped borders
    (rgbd_image.cpp:419-433); NaNs of invalid depth propagate."""
    nxt = torch.roll(img, -1, axis)
    prv = torch.roll(img, 1, axis)
    if axis == 1:
        nxt[:, -1] = img[:, -1]
        prv[:, 0] = img[:, 0]
    else:
        nxt[-1, :] = img[-1, :]
        prv[0, :] = img[0, :]
    return (nxt - prv) * 0.5


def _build_level(intensity, depth, K) -> RgbdLevel:
    idx = _central_diff(intensity, 1)
    idy = _central_diff(intensity, 0)
    zdx = _central_diff(depth, 1)
    zdy = _central_diff(depth, 0)
    planes = torch.stack([intensity, depth, idx, idy, zdx, zdy], -1)
    return RgbdLevel(intensity, depth, idx, idy, zdx, zdy, planes, K)


def build_rgbd_pyramid(intensity, depth, fx, fy, cx, cy,
                       num_levels: int = 4) -> Tuple[RgbdLevel, ...]:
    """RgbdImagePyramid: level 0 = the input (float32 tensors on one
    device); intensity 2x2 mean, depth 2x2 subsample (rgbd_image.cpp:
    164-169), K x 0.5 a level (intrinsic_matrix.cpp:90). Invalid depth is
    NaN or <= 0."""
    levels = [_build_level(intensity.float(), depth.float(),
                           (float(fx), float(fy), float(cx), float(cy)))]
    for _ in range(1, num_levels):
        prev = levels[-1]
        ih, iw = prev.intensity.shape
        i2 = prev.intensity[:ih - ih % 2, :iw - iw % 2]
        inten = (i2[0::2, 0::2] + i2[0::2, 1::2]
                 + i2[1::2, 0::2] + i2[1::2, 1::2]) * 0.25
        dep = prev.depth[:ih - ih % 2:2, :iw - iw % 2:2]
        fxl, fyl, cxl, cyl = prev.K
        levels.append(_build_level(
            inten, dep, (fxl * 0.5, fyl * 0.5, cxl * 0.5, cyl * 0.5)))
    return tuple(levels)


def _int_index(x, hi: int):
    """floor(x) as int64 clipped to [0, hi], with XLA's saturating float
    to int conversion (NaN -> 0)."""
    x = torch.where(torch.isnan(x), torch.zeros_like(x),
                    x.clamp(-2.0 ** 30, 2.0 ** 30))
    return x.to(torch.int32).clamp(0, hi).long()


def _warp_residuals(lvl_ref: RgbdLevel, lvl_cur: RgbdLevel, T, affine_a,
                    affine_b, ref_valid):
    """computeResidualsSse semantics on dense pixel grids.

    Returns r (N, 2), g_i (N, 2) the fx/255-scaled ESM intensity gradient,
    g_z (N, 2), p_ref (N, 3) reference 3D points, valid (N,).
    """
    H, W = lvl_ref.intensity.shape
    dev = lvl_ref.intensity.device
    # K as device scalars: the JAX package traces K, so (x - cx) / fx is a
    # true division there (CUDA's ``tensor / float`` multiplies a rounded
    # reciprocal).
    fx, fy, cx, cy = (const(float(k), dev) for k in lvl_ref.K)
    gy, gx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    z_ref = lvl_ref.depth
    # buildPointCloud (rgbd_image.cpp:245-262): ((x-ox)/fx, (y-oy)/fy, 1)*z
    px = (gx - cx) / fx * z_ref
    py = (gy - cy) / fy * z_ref
    R = T[:3, :3]
    t = T[:3, 3]
    q0 = R[0, 0] * px + R[0, 1] * py + R[0, 2] * z_ref + t[0]
    q1 = R[1, 0] * px + R[1, 1] * py + R[1, 2] * z_ref + t[1]
    zt = R[2, 0] * px + R[2, 1] * py + R[2, 2] * z_ref + t[2]
    zt_safe = torch.where(zt.abs() < 1e-12, torch.full_like(zt, 1e-12), zt)
    u = fx * q0 / zt_safe + cx
    v = fy * q1 / zt_safe + cy
    # inImage(x, y) && inImage(x+1, y+1) (dense_tracking_impl.cpp:78)
    inb = (u >= 0) & (v >= 0) & (u < W - 1) & (v < H - 1) & (zt > 0)

    x0 = torch.floor(u)
    y0 = torch.floor(v)
    wx1 = (u - x0).reshape(-1, 1)
    wy1 = (v - y0).reshape(-1, 1)
    idx00 = (_int_index(y0, H - 2) * W + _int_index(x0, W - 2)).reshape(-1)
    flat = lvl_cur.planes.reshape(-1, 6)
    # The corners (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1) and their
    # weights in the JAX package's order.
    interp = (flat[idx00] * ((1 - wx1) * (1 - wy1))
              + flat[idx00 + 1] * (wx1 * (1 - wy1))
              + flat[idx00 + W] * ((1 - wx1) * wy1)
              + flat[idx00 + W + 1] * (wx1 * wy1))         # (N, 6)

    i_cur, z_cur = interp[:, 0], interp[:, 1]
    idx_c, idy_c = interp[:, 2], interp[:, 3]
    zdx_c, zdy_c = interp[:, 4], interp[:, 5]

    i_ref = lvl_ref.intensity.reshape(-1)
    zr = z_ref.reshape(-1)
    ztf = zt.reshape(-1)
    # dense_tracking.cpp:228-235, dense_tracking_impl.cpp:270-276.
    r_i = (i_cur - (affine_a * i_ref + affine_b)) * (1.0 / 255.0)
    r_z = z_cur - ztf
    # ESM intensity derivative, current-only depth derivative.
    inv255 = reciprocal32(255.0)      # the JAX package's fx / 255.0
    g_iu = 0.5 * (idx_c + lvl_ref.idx.reshape(-1)) * (fx * inv255)
    g_iv = 0.5 * (idy_c + lvl_ref.idy.reshape(-1)) * (fy * inv255)
    g_zu = zdx_c * fx
    g_zv = zdy_c * fy

    # Occlusion gate (dense_tracking_impl.cpp:123-129,279):
    # sigma_z = 0.0012 + 0.0019 (z - 0.4)^2
    sigma_z = 0.0012 + 0.0019 * (zr - 0.4) ** 2
    finite = torch.isfinite(interp).all(-1)
    valid = (ref_valid.reshape(-1) & inb.reshape(-1) & finite
             & (r_z > -20.0 * sigma_z))

    r = torch.stack([r_i, r_z], -1)
    r = torch.where(valid[:, None], r, torch.zeros_like(r))
    p_ref = torch.stack([px.reshape(-1), py.reshape(-1), zr], -1)
    return (r, torch.stack([g_iu, g_iv], -1), torch.stack([g_zu, g_zv], -1),
            p_ref, valid)


def _system(r, g_i, g_z, p_ref, valid, w, prec):
    """A = sum J^T (w Lambda) J, b = -sum J^T (w Lambda) r
    (least_squares.cpp:58-64) with the 2x6 Jacobian of
    dense_tracking.cpp:355-366 at the reference point; columns
    [tx ty tz wx wy wz] (dense_tracking.cpp:490-520)."""
    x, y, z = p_ref[:, 0], p_ref[:, 1], p_ref[:, 2]
    zi = torch.where(z.abs() > 1e-12, 1.0 / z, torch.zeros_like(z))
    zi2 = zi * zi
    zero = torch.zeros_like(zi)
    one = torch.ones_like(zi)
    jw0 = torch.stack([zi, zero, -x * zi2, -x * y * zi2,
                       1.0 + x * x * zi2, -y * zi], -1)
    jw1 = torch.stack([zero, zi, -y * zi2, -(1.0 + y * y * zi2),
                       x * y * zi2, x * zi], -1)
    # Jz = dz'/dxi at p (dense_tracking.cpp:510-519)
    jz = torch.stack([zero, zero, one, y, -x, zero], -1)

    J0 = g_i[:, 0:1] * jw0 + g_i[:, 1:2] * jw1                 # (N, 6)
    J1 = g_z[:, 0:1] * jw0 + g_z[:, 1:2] * jw1 - jz
    Jt = torch.stack([J0, J1], 1)                              # (N, 2, 6)
    wm = torch.where(valid, w, torch.zeros_like(w))
    WL = wm[:, None, None] * prec[None]                        # (N, 2, 2)
    A = torch.einsum("nai,nab,nbj->ij", Jt, WL, Jt)
    b = -torch.einsum("nai,nab,nb->i", Jt, WL, r)
    return A, b


def _tdist_precision(r, valid, w):
    """Sigma = 1/(n-3) sum_i w_i r_i r_i^T, Lambda = Sigma^-1 (closed-form
    2x2 inverse; computeScale dense_tracking_impl.cpp:569-590), with the
    JAX package's variance floor (half a grey level in intensity, 0.0012 m
    in depth: on noiseless data one channel's residuals can be exactly 0)
    and its 1e-24 determinant guard. :return: (Lambda (2, 2), n)."""
    n = valid.float().sum()
    wm = torch.where(valid, w, torch.zeros_like(w))
    S = (torch.einsum("n,na,nb->ab", wm, r, r)
         / torch.clamp(n - 3.0, min=1.0))
    floor = const(((0.5 / 255.0) ** 2, 0.0012 ** 2), r.device)
    d = torch.diagonal(S)
    S = torch.diag(torch.maximum(d, floor) - d) + S
    det = S[0, 0] * S[1, 1] - S[0, 1] * S[1, 0]
    det = torch.where(det.abs() < 1e-24, torch.full_like(det, 1e-24), det)
    inv = torch.stack([torch.stack([S[1, 1], -S[0, 1]]),
                       torch.stack([-S[1, 0], S[0, 0]])]) / det
    return inv, n


def _mahalanobis(r, prec):
    return torch.einsum("na,ab,nb->n", r, prec, r)


def _tdist_weights(r, prec):
    return (NU + 2.0) / (NU + _mahalanobis(r, prec))


def _log_likelihood(r, valid, w, prec, n):
    """0.5 n log det(Lambda) - 0.5 (nu+2) sum log(1 + d/nu); the reference
    folds 1/nu into the 0.2 factor (dense_tracking_impl.cpp:409-430)."""
    d = _mahalanobis(r, prec)
    s = torch.where(valid, torch.log1p(0.2 * d), torch.zeros_like(d)).sum()
    det = prec[0, 0] * prec[1, 1] - prec[0, 1] * prec[1, 0]
    return (0.5 * n * torch.log(torch.clamp(det, min=1e-30))
            - 0.5 * (NU + 2.0) * s)


def dense_match_level(lvl_ref: RgbdLevel, lvl_cur: RgbdLevel, T_init,
                      lam_init, affine, cfg: DvoConfig = DvoConfig()) -> dict:
    """One pyramid level of DenseTracker::match (the do/while at
    dense_tracking.cpp:259-400). ``T_init`` (4, 4) maps reference points
    into the current frame (the reference API's ``Transformation`` is its
    inverse, dense_tracking.cpp:417); ``lam_init`` and ``affine`` (a, b)
    are tensors or numbers.

    Returns a dict of device tensors: T (ref->cur), T_api (= inv(T)),
    information (A x 0.008^2), log_likelihood, lambda, error, n.
    """
    dev = lvl_ref.intensity.device
    f32 = dict(dtype=torch.float32, device=dev)
    affine = torch.as_tensor(affine, **f32)
    affine_a, affine_b = affine[0], affine[1]
    # PointSelection predicate: finite positive depth + derivative
    # thresholds (both 0 in the tandem config).
    dmag = (lvl_ref.idx.abs() + lvl_ref.idy.abs()
            >= cfg.intensity_derivative_threshold)
    zmag = (lvl_ref.zdx.abs() + lvl_ref.zdy.abs()
            >= cfg.depth_derivative_threshold)
    ref_valid = (torch.isfinite(lvl_ref.depth) & (lvl_ref.depth > 0)
                 & dmag & zmag)
    I6 = torch.eye(6, **f32)

    # x starts as the log of the initial increment: the first iteration
    # applies T_init itself (dense_tracking.cpp:148-151,255-258), so the
    # estimate starts at identity.
    done = torch.zeros((), dtype=torch.bool, device=dev)
    x = se3_log(torch.as_tensor(T_init, **f32))
    est = torch.eye(4, **f32)
    lam = torch.as_tensor(lam_init, **f32).reshape(())
    last_err = torch.full((), float("inf"), **f32)
    prec_prev = torch.eye(2, **f32)
    A_last = torch.eye(6, **f32)
    ll_last = torch.full((), float("-inf"), **f32)
    n_last = torch.zeros((), **f32)
    for it in range(cfg.max_iterations):
        inc = se3_exp(x)
        est_new = inc @ est
        r, g_i, g_z, p_ref, valid = _warp_residuals(
            lvl_ref, lvl_cur, est_new, affine_a, affine_b, ref_valid)
        # Weights 1 on the level's first iteration (dense_tracking.cpp:
        # 303-310), afterwards from the previous precision.
        w = (torch.ones(r.shape[0], **f32) if it == 0
             else _tdist_weights(r, prec_prev))
        prec, n = _tdist_precision(r, valid, w)
        ll = _log_likelihood(r, valid, w, prec, n)
        err = -ll
        accept = (err < last_err) & ~(n < 6.0)

        A, b = _system(r, g_i, g_z, p_ref, valid, w, prec)
        A = A + cfg.mu * I6
        A = A * (1.0 + lam * I6)          # diag *= (1 + lambda)
        x_new = solve_gauss_jordan(A, b, 6)
        small = x_new.abs().max() <= cfg.precision
        # A finished loop keeps its carry (the while_loop's condition).
        take = accept & ~done
        x = torch.where(take, x_new, x)
        est = torch.where(take, est_new, est)
        lam = torch.where(take, lam * 0.5, lam)
        last_err = torch.where(take, err, last_err)
        prec_prev = torch.where(take, prec, prec_prev)
        A_last = torch.where(take, A, A_last)
        ll_last = torch.where(take, ll, ll_last)
        n_last = torch.where(take, n, n_last)
        done = done | ~accept | small
    Rt = est[:3, :3].T
    T_api = torch.eye(4, **f32)
    T_api[:3, :3] = Rt
    T_api[:3, 3] = -Rt @ est[:3, 3]
    return {"T": est, "T_api": T_api,
            "information": A_last * (0.008 * 0.008),   # dense_tracking.cpp:419
            "log_likelihood": ll_last, "lambda": lam, "error": last_err,
            "n": n_last}


def dense_match(ref_pyr: Sequence[RgbdLevel], cur_pyr: Sequence[RgbdLevel],
                T_init, cfg: DvoConfig = DvoConfig(),
                on_level: Optional[int] = None, lam: float = 0.01,
                affine_a: float = 1.0, affine_b: float = 0.0) -> dict:
    """DenseTracker::match over the level schedule. With ``on_level`` (the
    tandem runtime always passes 1, CoarseTracker.cpp:954) only that level
    runs; otherwise coarse to fine, first_level..last_level. Lambda threads
    across levels like the reference's by-reference float."""
    if on_level is not None:
        start = end = on_level
    else:
        start, end = cfg.first_level, cfg.last_level
    dev = ref_pyr[0].intensity.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = None
    T = torch.as_tensor(T_init, **f32)
    affine = const((float(affine_a), float(affine_b)), dev)
    lam_d = torch.as_tensor(lam, **f32)
    for level in range(start, end - 1, -1):
        out = dense_match_level(ref_pyr[level], cur_pyr[level], T, lam_d,
                                affine, cfg)
        T = out["T"]
        lam_d = out["lambda"]
    return out
