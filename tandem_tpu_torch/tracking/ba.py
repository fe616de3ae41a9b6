"""Sliding-window photometric bundle adjustment.

Port of ``tandem_tpu/tracking/ba.py`` (DSO's optimization backend,
tandem/src/OptimizationBackend/EnergyFunctional.{h,cpp} and
FullSystemOptimize.cpp:408-560): analytic DSO-style Jacobians of the
8-pattern photometric residual for every (point, target frame) pair at
once, the frame system assembled with one-hot products, the per-point
Schur complement as a rank-1 elimination (each point's inverse depth is a
scalar), an (8F+4)-dimensional system with the 4 global intrinsics
corrections, a marginalization prior with first-estimate Jacobians and the
gauge-nullspace orthogonalization.

``_system_terms`` and ``_assemble`` are K7, plain PyTorch ops here (the JAX
package's are XLA ops, not Pallas). Differences from the JAX package, none
of them in the arithmetic: the bilinear samples read the image planes
directly (the 4-corner packed tables are a TPU gather trick); the LM
``lax.while_loop`` is a fixed count of steps that change nothing once the
loop's condition is false, and the host reads that condition every
``CHECK_EVERY`` steps to stop early; the frame index of
``marginalize_frame`` is a Python int.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.se3 import se3_exp, se3_inverse, se3_log
from ..ops.linalg import inv_psd_small, solve_gauss_jordan
from ..utils.consts import const

# DSO's 8-point residual pattern (tandem/src/util/settings.h staticPattern).
PATTERN = ((0, -2), (-1, -1), (1, -1), (-2, 0),
           (0, 0), (2, 0), (-1, 1), (0, 2))

HUBER_TH = 9.0
# setting_outlierTHSumComponent = 50*50 (settings.cpp:85): gradient-based
# residual downweighting constant.
OUTLIER_TH_SUM_COMPONENT = 50.0 ** 2
# The LM loop reads its stop condition from the card every CHECK_EVERY
# iterations (a host read each).
CHECK_EVERY = 2


def _sdiv(a: float, x):
    """a / x with one rounding: ``float / tensor`` in PyTorch multiplies a
    rounded reciprocal by a."""
    return torch.div(const(a, x.device, x.dtype), x)


def pattern(device) -> torch.Tensor:
    """(8, 2) float32 pattern offsets (dx, dy)."""
    return const(PATTERN, torch.device(device))


class BAState(NamedTuple):
    poses: torch.Tensor       # (F, 4, 4) cam_to_world
    aff: torch.Tensor         # (F, 2) (a, b)
    frame_valid: torch.Tensor  # (F,) bool
    pt_frame: torch.Tensor    # (N,) int64 host frame slot
    pt_uv: torch.Tensor       # (N, 2) pixel in the host frame
    pt_idepth: torch.Tensor   # (N,)
    pt_color: torch.Tensor    # (N, 8) host pattern intensities
    pt_valid: torch.Tensor    # (N,) bool
    # Marginalization prior over frame + calib parameters (8 per slot, 4
    # calib last): energy 0.5 d^T Hm d + bm^T d, d the deviation from the
    # FEJ linearization point (poses_lin, aff_lin, calib_lin).
    Hm: torch.Tensor          # (F*8+4, F*8+4)
    bm: torch.Tensor          # (F*8+4,)
    poses_lin: torch.Tensor   # (F, 4, 4)
    aff_lin: torch.Tensor     # (F, 2)
    # Correction (d_fx, d_fy, d_cx, d_cy) of the boot calibration (DSO's
    # CalibHessian), anchored by the prior seeded in create_ba_state.
    calib: torch.Tensor       # (4,)
    calib_lin: torch.Tensor   # (4,)


def create_ba_state(num_frames: int, num_points: int,
                    calib_prior: float = 2e6, device="cuda") -> BAState:
    """An empty window of F frame slots and N point slots. ``calib_prior``
    is DSO's setting_initialCalibHessian on raw pixels (settings.cpp:52);
    keep it at this strength: only BA consumes the calib correction."""
    F, N, P = num_frames, num_points, num_frames * 8 + 4
    eye = torch.eye(4, device=device).expand(F, 4, 4).clone()
    Hm = torch.zeros((P, P), device=device)
    idx = torch.arange(F * 8, P, device=device)
    Hm[idx, idx] = calib_prior
    return BAState(
        poses=eye, aff=torch.zeros((F, 2), device=device),
        frame_valid=torch.zeros(F, dtype=torch.bool, device=device),
        pt_frame=torch.zeros(N, dtype=torch.long, device=device),
        pt_uv=torch.zeros((N, 2), device=device),
        pt_idepth=torch.ones(N, device=device),
        pt_color=torch.zeros((N, 8), device=device),
        pt_valid=torch.zeros(N, dtype=torch.bool, device=device),
        Hm=Hm, bm=torch.zeros(P, device=device), poses_lin=eye.clone(),
        aff_lin=torch.zeros((F, 2), device=device),
        calib=torch.zeros(4, device=device),
        calib_lin=torch.zeros(4, device=device))


def _prior_delta(state: BAState):
    """Deviation of the current estimate from the FEJ linearization point in
    the local increment convention (pose = pose_lin @ exp(-delta)): (F*8+4,)."""
    rel = se3_inverse(state.poses_lin) @ state.poses
    d = torch.cat([-se3_log(rel), state.aff - state.aff_lin], -1)
    d = torch.where(state.frame_valid[:, None], d, torch.zeros_like(d))
    return torch.cat([d.reshape(-1), state.calib - state.calib_lin])


def gauge_nullspaces(poses, frame_valid):
    """Gauge-nullspace basis of the window (DSO getNullspaces,
    EnergyFunctional.cpp:718): global translation x3, rotation x3, scale and
    the 2 global affine shifts, evaluated numerically through the group
    action; the 4 calib rows are zero. :return: (F*8+4, 9)."""
    F = poses.shape[0]
    dev = poses.device
    eps = 1e-4
    w2c = se3_inverse(poses)
    zeros2 = torch.zeros((F, 2), device=dev)

    def masked(d):
        return torch.where(frame_valid[:, None], d, torch.zeros_like(d))

    cols = []
    for k in range(6):
        xi = torch.zeros(6, device=dev)
        xi[k] = eps
        rel = w2c @ se3_exp(xi) @ poses
        d = masked(-se3_log(rel) / eps)
        cols.append(torch.cat([d, zeros2], -1).reshape(-1))
    scaled = poses.clone()
    scaled[:, :3, 3] = scaled[:, :3, 3] * (1.0 + eps)
    d = masked(-se3_log(w2c @ scaled) / eps)
    cols.append(torch.cat([d, zeros2], -1).reshape(-1))
    for j in range(2):
        da = torch.zeros((F, 2), device=dev)
        da[:, j] = 1.0
        cols.append(torch.cat([torch.zeros((F, 6), device=dev), masked(da)],
                              -1).reshape(-1))
    ns = torch.stack(cols, -1)
    return torch.cat([ns, torch.zeros((4, ns.shape[1]), device=dev)], 0)


def _orthogonalize_prior(Hm, bm, nullspaces):
    """Project the marginalization prior onto the complement of the gauge
    nullspace (EnergyFunctional.cpp:718 orthogonalize)."""
    N = nullspaces
    NtN = N.T @ N + 1e-8 * torch.eye(N.shape[1], device=N.device)
    NP = N @ inv_psd_small(NtN, N.shape[1])
    bm = bm - NP @ (N.T @ bm)
    Hm = Hm - NP @ (N.T @ Hm)
    Hm = Hm - (Hm @ N) @ NP.T
    return 0.5 * (Hm + Hm.T), bm


def _corners(x, y, H: int, W: int):
    """Bilinear corner indices (row-major, into an (H, W) plane) and the
    four weights, in the JAX package's corner order; indices clipped."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    xi = x0.to(torch.int32).clamp(0, W - 2).long()
    yi = y0.to(torch.int32).clamp(0, H - 2).long()
    i00 = yi * W + xi
    return ((i00, i00 + 1, i00 + W, i00 + W + 1),
            ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy))


def _bilinear(img, x, y):
    """Bilinear sample of an (H, W) image at float pixels x, y."""
    H, W = img.shape
    idx, wts = _corners(x, y, H, W)
    flat = img.reshape(-1)
    out = flat[idx[0]] * wts[0]
    for k in range(1, 4):
        out = out + flat[idx[k]] * wts[k]
    return out


def _residual_one(dx_h, dx_t, id_n, pose_h, pose_t, aff_h, aff_t, uv, colors,
                  img_t, K, dk=None):
    """8-pattern residual of one point in one target frame, the reference
    the analytic Jacobians of ``_system_terms`` are validated against.

    dx_h/dx_t: (8,) increments [xi(6), da, db] on top of (pose_*, aff_*),
    applied as c2w <- c2w exp(-xi); dk: (4,) increments of (fx, fy, cx,
    cy). :return: (r (8,), ok (8,) bool)
    """
    dev = img_t.device
    if dk is None:
        dk = torch.zeros(4, device=dev)
    fx, fy, cx, cy = (K[0] + dk[0], K[1] + dk[1], K[2] + dk[2],
                      K[3] + dk[3])
    c2w_h = pose_h @ se3_exp(-dx_h[:6])
    c2w_t = pose_t @ se3_exp(-dx_t[:6])
    a_h, b_h = aff_h[0] + dx_h[6], aff_h[1] + dx_h[7]
    a_t, b_t = aff_t[0] + dx_t[6], aff_t[1] + dx_t[7]
    T_th = se3_inverse(c2w_t) @ c2w_h
    R, t = T_th[:3, :3], T_th[:3, 3]
    pat = pattern(dev)
    u = uv[0] + pat[:, 0]
    v = uv[1] + pat[:, 1]
    ray = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)
    q = ray @ R.T + t[None] * id_n
    qz = q[:, 2]
    qz_safe = torch.where(qz > 1e-6, qz, torch.ones_like(qz))
    px = fx * q[:, 0] / qz_safe + cx
    py = fy * q[:, 1] / qz_safe + cy
    H, W = img_t.shape
    ok = (qz > 1e-6) & (px > 2) & (px < W - 3) & (py > 2) & (py < H - 3)
    gain = torch.exp(a_t - a_h)
    r = _bilinear(img_t, px, py) - gain * colors - (b_t - gain * b_h)
    return torch.where(ok, r, torch.zeros_like(r)), ok


def _image_gradients(images):
    """Central-difference gradients of (F, H, W) images, zero on the
    border."""
    gx = torch.zeros_like(images)
    gy = torch.zeros_like(images)
    gx[:, :, 1:-1] = 0.5 * (images[:, :, 2:] - images[:, :, :-2])
    gy[:, 1:-1, :] = 0.5 * (images[:, 2:, :] - images[:, :-2, :])
    return gx, gy


def _flat_trilerp(stacked, px, py):
    """Bilinear-sample (F, H, W, C) ``stacked`` at (px, py), where axis 1 of
    px/py is the frame: (N, F, 8) -> (N, F, 8, C)."""
    F, H, W, C = stacked.shape
    idx, wts = _corners(px, py, H, W)
    base = (torch.arange(F, device=px.device) * (H * W))[None, :, None]
    table = stacked.reshape(F * H * W, C)
    out = table[idx[0] + base] * wts[0][..., None]
    for k in range(1, 4):
        out = out + table[idx[k] + base] * wts[k][..., None]
    return out


def _nanquantile(vals, q: float):
    """``jnp.nanquantile(vals, q)`` (linear) over all entries, with the JAX
    package's float32 arithmetic; NaN when every entry is NaN."""
    a = torch.sort(vals.reshape(-1)).values      # NaNs sort last
    count = (~torch.isnan(a)).sum().float()
    qq = const(q, a.device) * (count - 1)
    low, high = torch.floor(qq), torch.ceil(qq)
    hw = qq - low
    lw = 1 - hw
    lo = torch.maximum(torch.zeros_like(low), torch.minimum(low, count - 1))
    hi = torch.maximum(torch.zeros_like(high), torch.minimum(high, count - 1))
    return a[lo.long()] * lw + a[hi.long()] * hw


def _hat(p):
    z = torch.zeros_like(p[..., 0])
    return torch.stack([
        torch.stack([z, -p[..., 2], p[..., 1]], -1),
        torch.stack([p[..., 2], z, -p[..., 0]], -1),
        torch.stack([-p[..., 1], p[..., 0], z], -1)], -2)


def _system_terms(state: BAState, images, K, newest_slot=None):
    """K7: residuals and analytic Jacobians for all (point, target) pairs
    (DSO's linearize, Residuals.cpp).

    :param images: (F, H, W) level-0 intensities
    :param K: (fx, fy, cx, cy) boot calibration (floats)
    :param newest_slot: window slot of the newest keyframe: the source of
        the adaptive pair-outlier threshold (setNewFrameEnergyTH); None
        takes the quantile over all active pairs
    :return: r (N, F, 8), J_frames (N, F, 8, 16) wrt [host(8), target(8)]
        with per-slot layout [xi(6), a, b], J_id (N, F, 8), J_K (N, F, 8, 4),
        w (N, F, 8), active (N, F), e_total (0-d, outlier pairs clamped at
        the threshold)
    """
    _system_terms.calls += 1
    dev = images.device
    fx = K[0] + state.calib[0]
    fy = K[1] + state.calib[1]
    cx = K[2] + state.calib[2]
    cy = K[3] + state.calib[3]
    F, H, W = images.shape
    pat = pattern(dev)

    pose_h = state.poses[state.pt_frame]          # (N, 4, 4)
    aff_h = state.aff[state.pt_frame]             # (N, 2)
    w2c_t = se3_inverse(state.poses)              # (F, 4, 4)
    T = torch.einsum("fij,njk->nfik", w2c_t, pose_h)  # (N, F, 4, 4)
    R = T[..., :3, :3]
    t = T[..., :3, 3]

    u = state.pt_uv[:, 0:1] + pat[None, :, 0]
    v = state.pt_uv[:, 1:2] + pat[None, :, 1]
    ray = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], -1)

    idn = state.pt_idepth[:, None, None]          # (N, 1, 1)
    q = (torch.einsum("nfij,npj->nfpi", R, ray)
         + t[:, :, None, :] * idn[..., None])     # (N, F, 8, 3)
    qz = q[..., 2]
    qz_safe = torch.where(qz > 1e-6, qz, torch.ones_like(qz))
    px = fx * q[..., 0] / qz_safe + cx
    py = fy * q[..., 1] / qz_safe + cy
    ok = (qz > 1e-6) & (px > 2) & (px < W - 3) & (py > 2) & (py < H - 3)

    gx_im, gy_im = _image_gradients(images)
    stacked = torch.stack([images, gx_im, gy_im], -1)  # (F, H, W, 3)
    samp = _flat_trilerp(stacked, px, py)
    hit, gx, gy = samp[..., 0], samp[..., 1], samp[..., 2]

    a_t = state.aff[None, :, 0:1]                 # (1, F, 1)
    b_t = state.aff[None, :, 1:2]
    a_h = aff_h[:, None, 0:1]                     # (N, 1, 1)
    b_h = aff_h[:, None, 1:2]
    gain = torch.exp(a_t - a_h)
    colors = state.pt_color[:, None, :]           # (N, 1, 8)
    r = hit - gain * colors - (b_t - gain * b_h)
    r = torch.where(ok, r, torch.zeros_like(r))

    # d pixel / d q, then dr/dq
    inv_z = 1.0 / qz_safe
    zero = torch.zeros_like(inv_z)
    du_dq = torch.stack([fx * inv_z, zero, -fx * q[..., 0] * inv_z * inv_z],
                        -1)
    dv_dq = torch.stack([zero, fy * inv_z, -fy * q[..., 1] * inv_z * inv_z],
                        -1)
    g_dq = gx[..., None] * du_dq + gy[..., None] * dv_dq

    # Increment convention: c2w <- c2w exp(-dx) (w2c <- exp(dx) w2c).
    Jt_v = idn[..., None] * g_dq
    Jt_w = -torch.einsum("nfpi,nfpij->nfpj", g_dq, _hat(q))
    g_R = torch.einsum("nfpi,nfij->nfpj", g_dq, R)
    Jh_v = -idn[..., None] * g_R
    Jh_w = torch.einsum("nfpi,npij->nfpj", g_R, _hat(ray))
    dgain = gain * (colors - b_h)
    Jt_a = -dgain
    Jt_b = -torch.ones_like(r)
    Jh_a = dgain
    Jh_b = gain * torch.ones_like(r)
    Ji = torch.einsum("nfpi,nfi->nfp", g_dq, t)

    # Intrinsics (fx, fy, cx, cy): host back-projection and target
    # projection both move (DSO's ResidualProjections).
    rx = ray[..., 0][:, None, :]
    ry = ray[..., 1][:, None, :]
    J_fx = gx * q[..., 0] * inv_z - (rx / fx) * g_R[..., 0]
    J_fy = gy * q[..., 1] * inv_z - (ry / fy) * g_R[..., 1]
    J_cx = gx - g_R[..., 0] / fx
    J_cy = gy - g_R[..., 1] / fy
    J_K = torch.stack([J_fx, J_fy, J_cx, J_cy], -1)

    Jf = torch.cat([Jh_v, Jh_w, Jh_a[..., None], Jh_b[..., None],
                    Jt_v, Jt_w, Jt_a[..., None], Jt_b[..., None]], -1)

    tgt = torch.arange(F, device=dev)
    active = (state.pt_valid[:, None] & state.frame_valid[None, :]
              & (state.pt_frame[:, None] != tgt[None, :]))
    absr = torch.abs(r)
    hw = torch.where(absr < HUBER_TH, torch.ones_like(absr),
                     _sdiv(HUBER_TH, torch.clamp(absr, min=1e-9)))
    # Gradient-dependent downweight (Residuals.cpp:203).
    wg = torch.sqrt(_sdiv(OUTLIER_TH_SUM_COMPONENT,
                          OUTLIER_TH_SUM_COMPONENT + gx * gx + gy * gy))
    mask = ok.float() * active[..., None].float()

    # Per-pair outlier gate (Residuals.cpp:262-266) against the adaptive
    # threshold of setNewFrameEnergyTH (FullSystemOptimize.cpp:93-131).
    e_px = wg * wg * hw * (2.0 - hw) * r * r * mask
    e_pair = e_px.sum(2)                                  # (N, F)
    pair_active = active & ok.any(2)
    sel = pair_active
    if newest_slot is not None:
        sel = sel & (tgt[None, :] == newest_slot)
    vals = torch.where(sel, e_pair, torch.full_like(e_pair, float("nan")))
    nth = torch.sqrt(torch.clamp(_nanquantile(vals, 0.7), min=0.0))
    th = torch.square(0.5 * 26.0 + 0.5 * 1.5 * nth)
    th = torch.where(torch.isfinite(th), th, torch.full_like(th, 144.0 * 8.0))
    inlier = (e_pair <= th)[..., None].float()

    w = wg * hw * mask * inlier
    e_total = torch.where(pair_active, torch.minimum(e_pair, th),
                          torch.zeros_like(e_pair)).sum()
    return r, Jf, Ji, J_K, w, active, e_total


_system_terms.calls = 0


def _assemble(state: BAState, r, Jf, Ji, J_K, w):
    """K7's reduction: the Schur-reduced frame+calib system (8F+4 columns;
    the 4 calib columns are global)."""
    F = state.poses.shape[0]
    N = state.pt_frame.shape[0]
    host_oh = torch.nn.functional.one_hot(state.pt_frame, F).float()
    tgt_oh = torch.eye(F, device=r.device)

    Jh = Jf[..., :8]
    Jt = Jf[..., 8:]
    G = (Jh[:, :, :, None, :] * host_oh[:, None, None, :, None]
         + Jt[:, :, :, None, :] * tgt_oh[None, :, None, :, None])
    G = torch.cat([G.reshape(N, F, 8, F * 8), J_K], -1)

    wG = G * w[..., None]
    H_ff = torch.einsum("nfrp,nfrq->pq", wG, G)
    b_f = torch.einsum("nfrp,nfr->p", wG, r)
    H_pp = torch.einsum("nfr,nfr->n", w * Ji, Ji)
    H_fp = torch.einsum("nfrp,nfr->np", wG, Ji)
    b_p = torch.einsum("nfr,nfr->n", w * Ji, r)
    energy = (w * r * r).sum()
    return H_ff, b_f, H_pp, H_fp, b_p, energy


def _prior_energy(state: BAState):
    d = _prior_delta(state)
    return 2.0 * torch.dot(state.bm, d) + torch.dot(d, state.Hm @ d)


def _total_energy(state: BAState, images, K):
    """Residual energy + marginalization-prior energy at the current
    estimate (FullSystemOptimize.cpp:470-545 + calcMEnergy)."""
    e_res = _system_terms(state, images, K)[6]
    return e_res + _prior_energy(state)


def ba_iterate(state: BAState, images, K, iters: int = 6,
               idepth_prior: float = 1e-1, newest_slot=None):
    """Windowed LM with energy-based accept/reject
    (FullSystemOptimize.cpp:470-545): solve, apply, compare the total
    energy; accept -> lambda x0.25, reject -> revert + lambda x1e2; stop
    when an accepted step is tiny or lambda exceeds 1e5. The prior enters
    with first-estimate Jacobians (Hm fixed, b = bm + Hm delta).

    :param images: (F, H, W); K: (fx, fy, cx, cy) floats
    :return: (new_state, energy)
    """
    F = state.poses.shape[0]
    P = F * 8 + 4
    dev = images.device
    gauge = torch.zeros(P, device=dev)
    gauge[:8] = 1e8                   # frame 0 pose + affine held
    eyeP = torch.eye(P, device=dev)

    def system_of(cur):
        r, Jf, Ji, J_K, w, _, e_res = _system_terms(cur, images, K,
                                                    newest_slot)
        H_ff, b_f, H_pp, H_fp, b_p, _ = _assemble(cur, r, Jf, Ji, J_K, w)
        return [H_ff, b_f, H_pp, H_fp, b_p], e_res + _prior_energy(cur)

    # The accepted state's system rides along, so each iteration evaluates
    # _system_terms once (the candidate's doubles as the next system).
    sys_r, energy = system_of(state)
    poses, aff, idepth, calib = (state.poses, state.aff, state.pt_idepth,
                                 state.calib)
    lam = torch.full((), 1e-3, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for it in range(iters):
        if it and it % CHECK_EVERY == 0 and bool(done):
            break
        H_ff_r, b_f_r, H_pp, H_fp, b_p = sys_r
        cur = state._replace(poses=poses, aff=aff, pt_idepth=idepth,
                             calib=calib)
        d = _prior_delta(cur)
        H_ff = H_ff_r + cur.Hm + torch.diag(gauge)
        b_f = b_f_r + cur.bm + cur.Hm @ d

        H_pp_safe = H_pp + idepth_prior
        H_sc = torch.einsum("np,n,nq->pq", H_fp, 1.0 / H_pp_safe, H_fp)
        b_sc = torch.einsum("np,n->p", H_fp, b_p / H_pp_safe)
        A = H_ff - H_sc + lam * torch.diag(torch.diag(H_ff)) + 1e-6 * eyeP
        dx = solve_gauss_jordan(A, -(b_f - b_sc), P)
        d_id = -(b_p + H_fp @ dx) / H_pp_safe
        d_id = torch.where(cur.pt_valid, d_id, torch.zeros_like(d_id))

        # A degenerate window must not poison the state with NaNs.
        finite = torch.isfinite(dx).all() & torch.isfinite(d_id).all()
        dx = torch.where(finite, dx, torch.zeros_like(dx))
        d_id = torch.where(finite, d_id, torch.zeros_like(d_id))

        dxf = dx[:F * 8].reshape(F, 8)
        upd = cur.frame_valid[:, None]
        new_poses = poses @ se3_exp(
            -torch.where(upd, dxf[:, :6], torch.zeros_like(dxf[:, :6])))
        new_aff = aff + torch.where(upd, dxf[:, 6:],
                                    torch.zeros_like(dxf[:, 6:]))
        new_id = torch.clamp(idepth + d_id, 1e-4, 1e3)
        new_calib = calib + dx[F * 8:]

        cand = state._replace(poses=new_poses, aff=new_aff,
                              pt_idepth=new_id, calib=new_calib)
        c_sys, e_new = system_of(cand)
        accept = torch.isfinite(e_new) & (e_new < energy)
        step = torch.abs(dx).max()
        done_new = (accept & (step < 1e-5)) | (~accept & (lam > 1e5))
        lam_new = torch.where(accept, torch.clamp(lam * 0.25, min=1e-6),
                              torch.clamp(lam * 1e2, max=1e7))

        # Once done, an iteration changes nothing (the while_loop's exit).
        take = accept & ~done
        live = ~done

        def sel(a, b):
            return torch.where(take, a, b)
        poses, aff = sel(new_poses, poses), sel(new_aff, aff)
        idepth, calib = sel(new_id, idepth), sel(new_calib, calib)
        energy = sel(e_new, energy)
        sys_r = [sel(a, b) for a, b in zip(c_sys, sys_r)]
        lam = torch.where(live, lam_new, lam)
        done = done | (live & done_new)
    return state._replace(poses=poses, aff=aff, pt_idepth=idepth,
                          calib=calib), energy


def ba_log_system(state: BAState, images, K):
    """Schur-reduced window system for debug logging (DSO's lastHS /
    lastbS, EnergyFunctional.cpp:842-848), in DSO's column order: the 4
    calib columns first, then 8 per frame.

    :return: (H (P, P), b (P,), nullspaces (P, 9), n_active_residuals)
    """
    F = state.poses.shape[0]
    dev = images.device
    r, Jf, Ji, J_K, w, active, _ = _system_terms(state, images, K)
    H_ff, b_f, H_pp, H_fp, b_p, _ = _assemble(state, r, Jf, Ji, J_K, w)
    d = _prior_delta(state)
    H = H_ff + state.Hm
    b = b_f + state.bm + state.Hm @ d
    H_pp_safe = H_pp + 1e-1
    H = H - torch.einsum("np,n,nq->pq", H_fp, 1.0 / H_pp_safe, H_fp)
    b = b - torch.einsum("np,n->p", H_fp, b_p / H_pp_safe)
    perm = torch.cat([torch.arange(F * 8, F * 8 + 4, device=dev),
                      torch.arange(F * 8, device=dev)])
    ns = gauge_nullspaces(state.poses, state.frame_valid)[perm]
    return H[perm][:, perm], b[perm], ns, active.long().sum()


def remove_outliers(state: BAState, images, K,
                    energy_threshold: float = 12.0 ** 2):
    """Deactivate points whose mean per-pixel residual energy over their
    inlier observations exceeds the threshold, or that have no inlier
    observation left (FullSystem removeOutliers / flagPointsForRemoval)."""
    r, _, _, _, w, _, _ = _system_terms(state, images, K)
    ok = (w > 0).float()
    e = (r * r * ok).sum((1, 2)) / torch.clamp(ok.sum((1, 2)), min=1.0)
    n_obs = (w > 0).any(2).sum(1)
    bad = (e > energy_threshold) | (n_obs < 1)
    return state._replace(pt_valid=state.pt_valid & ~bad)


def marginalize_frame(state: BAState, images, K, frame_idx: int):
    """Fold one frame's parameters into the prior (Hm, bm) and deactivate it
    (EnergyFunctional::marginalizeFrame). Only the residuals that involve
    the frame are folded; the points it hosts are dropped after their
    information is absorbed; the new prior is orthogonalized against the
    gauge nullspace at the new linearization point."""
    F = state.poses.shape[0]
    P = F * 8 + 4
    dev = images.device

    r, Jf, Ji, J_K, w, _, _ = _system_terms(state, images, K)
    involved = ((state.pt_frame[:, None] == frame_idx)
                | (torch.arange(F, device=dev)[None, :] == frame_idx))
    w = w * involved[..., None].to(w.dtype)
    H_ff, b_f, H_pp, H_fp, b_p, _ = _assemble(state, r, Jf, Ji, J_K, w)

    H_pp_safe = H_pp + 1e-1
    H_ff = H_ff - torch.einsum("np,n,nq->pq", H_fp, 1.0 / H_pp_safe, H_fp)
    b_f = b_f - torch.einsum("np,n->p", H_fp, b_p / H_pp_safe)

    H = H_ff + state.Hm
    b = b_f + state.bm + state.Hm @ _prior_delta(state)

    sl = frame_idx * 8
    idx = torch.arange(P, device=dev)
    keep = ~((idx >= sl) & (idx < sl + 8))
    Hbb8 = H[sl:sl + 8, sl:sl + 8] + 1e-4 * torch.eye(8, device=dev)
    Hab = torch.where(keep[:, None] & ~keep[None, :], H, torch.zeros_like(H))
    Hab8 = Hab[:, sl:sl + 8]
    Hbb_inv = inv_psd_small(Hbb8, 8)
    Hm_new = H - Hab8 @ Hbb_inv @ Hab8.T
    bm_new = b - Hab8 @ (Hbb_inv @ b[sl:sl + 8])
    Hm_new = torch.where(keep[:, None] & keep[None, :], Hm_new,
                         torch.zeros_like(Hm_new))
    Hm_new = 0.5 * (Hm_new + Hm_new.T)
    bm_new = torch.where(keep, bm_new, torch.zeros_like(bm_new))

    frame_valid = state.frame_valid.clone()
    frame_valid[frame_idx] = False
    ns = gauge_nullspaces(state.poses, frame_valid)
    Hm_new, bm_new = _orthogonalize_prior(Hm_new, bm_new, ns)
    return state._replace(
        frame_valid=frame_valid,
        pt_valid=state.pt_valid & (state.pt_frame != frame_idx),
        Hm=Hm_new, bm=bm_new, poses_lin=state.poses, aff_lin=state.aff,
        calib_lin=state.calib)
