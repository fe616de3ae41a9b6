"""CoarseInitializer: joint multi-level pose + per-point inverse-depth LM
for the monocular bootstrap.

Port of ``tandem_tpu/tracking/initializer.py`` (the reference's
tandem/src/FullSystem/CoarseInitializer.{h,cpp}: setFirst, trackFrame with
its alpha/coupling prior schedule and "snapped" detection, propagateUp/Down
and the snapped && frameID > snappedAt + 5 criterion). Fixed-capacity point
lists per level; each LM iteration evaluates all points x 8 pattern pixels
at once (``_calc_res_gs``, K11: plain PyTorch ops here, XLA ops in the JAX
package); the 10-nearest-neighbour graph is the JAX package's grid stand-in
(a splat and a box filter).

Differences from the JAX package, none of them in the arithmetic: the new
frame's level planes are sampled directly (the JAX package's corner-packed
table, ``_pack_level``, is a TPU gather trick) with the same corner order,
weights and sum order; the unused reference-pyramid tables are not kept; a
level's ``lax.while_loop`` is a fixed count of steps that change nothing
once the loop's condition is false, and the host reads that condition
every ``CHECK_EVERY`` steps to stop early.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..core.pyramid import build_pyramid, pyramid_intrinsics
from ..core.se3 import se3_exp, se3_log
from ..ops.linalg import solve_gauss_jordan
from ..ops.track_reduce import bilinear_with_grad
from .ba import _sdiv, pattern
from .point_selection import select_pixels

NUM_LEVELS = 6
MAX_ITERS = (5, 5, 10, 30, 50, 50)       # maxIterations[] (:88)
ALPHA_K = 2.5 * 2.5                      # :92
ALPHA_W = 150.0 * 150.0                  # :93
REG_WEIGHT = 0.8                         # :94
COUPLING_WEIGHT = 1.0                    # :95
HUBER_TH = 9.0                           # setting_huberTH
OUTLIER_E = 8 * 12.0 * 12.0 * 20.0       # energy > outlierTH*20 (:457)
MAX_PIXEL_STEP = 0.25                    # doStep (:885)
EPS_INC = 1e-4                           # :135
# Per-level selection: candidate-cell size + list capacity (PixelSelector
# densities, CoarseInitializer.cpp:778).
POTENTIALS = (4, 2, 2, 1, 1, 1)
CAPS = (8192, 4096, 2048, 1024, 512, 256)
# A level's LM loop reads its stop condition every CHECK_EVERY iterations.
CHECK_EVERY = 5


class InitializerState(NamedTuple):
    """Per-level fixed-capacity point lists (fine -> coarse) + frame state."""
    pu: Tuple[torch.Tensor, ...]          # (N_l,) pixel x (integer-valued)
    pv: Tuple[torch.Tensor, ...]          # (N_l,) pixel y
    pcolor: Tuple[torch.Tensor, ...]      # (N_l, 8) ref pattern intensities
    pvalid: Tuple[torch.Tensor, ...]      # (N_l,) selection mask
    idepth: Tuple[torch.Tensor, ...]      # (N_l,)
    iR: Tuple[torch.Tensor, ...]          # (N_l,) regularized target
    last_hessian: Tuple[torch.Tensor, ...]  # (N_l,) idepth Hessian
    is_good: Tuple[torch.Tensor, ...]     # (N_l,) bool
    energy: Tuple[torch.Tensor, ...]      # (N_l,) accepted energy
    T: torch.Tensor                       # (4, 4) thisToNext (ref -> new)
    aff: torch.Tensor                     # (2,) (a_log, b)
    snapped: torch.Tensor                 # () bool
    snapped_at: torch.Tensor              # () int32
    frame_id: torch.Tensor                # () int32


def _level_dims(H: int, W: int):
    return [(H >> lvl, W >> lvl) for lvl in range(NUM_LEVELS)]


def nonzero_fixed(flat, size: int):
    """``jnp.nonzero(flat, size=size, fill_value=-1)[0]``: the indices of
    the first ``size`` set entries in order, -1-padded, with no host read."""
    pos = torch.cumsum(flat.long(), 0) - 1
    dst = torch.where(flat & (pos < size), pos, torch.full_like(pos, size))
    idx = torch.full((size + 1,), -1, dtype=torch.long, device=flat.device)
    idx.scatter_(0, dst, torch.arange(flat.numel(), device=flat.device))
    return idx[:size]


def make_initializer(image, fx, fy, cx, cy) -> InitializerState:
    """setFirst: select points at every pyramid level, idepth = 1."""
    dev = image.device
    pyr = build_pyramid(image, NUM_LEVELS)
    pat = pattern(dev)
    lists = []
    for lvl in range(NUM_LEVELS):
        img = pyr[lvl]["img"]
        Hl, Wl = img.shape
        cap = CAPS[lvl]
        if Hl >= 64:
            # Density adaptation: a laxer threshold when gradients are weak.
            m_hi = select_pixels(pyr[lvl]["abs_grad2"], block=32,
                                 potential=POTENTIALS[lvl],
                                 threshold_factor=1.0)
            m_lo = select_pixels(pyr[lvl]["abs_grad2"], block=32,
                                 potential=POTENTIALS[lvl],
                                 threshold_factor=0.2)
            enough = m_hi.long().sum() >= cap // 4
            mask = torch.where(enough, m_hi, m_lo)
        else:
            # Tiny coarse levels: every non-border pixel with any gradient.
            border = torch.zeros((Hl, Wl), dtype=torch.bool, device=dev)
            border[3:-3, 3:-3] = True
            mask = (pyr[lvl]["abs_grad2"] > 1.0) & border
        idx = nonzero_fixed(mask.reshape(-1), cap)
        ok = idx >= 0
        idxc = torch.clamp(idx, min=0)
        u = (idxc % Wl).float()
        v = (idxc // Wl).float()
        # Integer coords + integer pattern: a direct lookup (negative
        # indices of the padding wrap, as in the JAX package).
        uu = (u[:, None] + pat[:, 0]).long()
        vv = (v[:, None] + pat[:, 1]).long()
        col = img.reshape(-1)[(vv * Wl + uu).reshape(-1)].reshape(cap, 8)
        lists.append((u, v, col, ok, torch.ones(cap, device=dev),
                      torch.ones(cap, device=dev),
                      torch.zeros(cap, device=dev), ok,
                      torch.zeros(cap, device=dev)))
    pu, pv, pcol, pval, idep, iR, lastH, isG, en = zip(*lists)
    return InitializerState(
        pu=pu, pv=pv, pcolor=pcol, pvalid=pval, idepth=idep, iR=iR,
        last_hessian=lastH, is_good=isG, energy=en,
        T=torch.eye(4, device=dev), aff=torch.zeros(2, device=dev),
        snapped=torch.tensor(False, device=dev),
        snapped_at=torch.tensor(0, dtype=torch.int32, device=dev),
        frame_id=torch.tensor(0, dtype=torch.int32, device=dev))


def _box_sum(x, radius: int):
    """Sum over the (2r+1)^2 window of a zero-padded (H, W) map. One
    ``avg_pool2d`` with divisor 1 adds the window row by row from 0, the
    order of the JAX package's (2r+1)^2 shifted adds (padding is skipped,
    which adds nothing): bit-equal to them."""
    k = 2 * radius + 1
    return F.avg_pool2d(x[None, None], k, stride=1, padding=radius,
                        count_include_pad=True, divisor_override=1)[0, 0]


def _splat(flat, val, size: int):
    """Scatter-add val at the flat pixel indices into a zero map. Indices
    repeat only on the padding of the point lists, whose values are 0."""
    return torch.zeros(size, device=val.device).index_put_(
        (flat,), val, accumulate=True)


def _neighbor_mean(pu, pv, val, weight, Hl: int, Wl: int, radius: int = 4):
    """Splat (val*weight, weight) to the level grid and box-filter: the
    grid stand-in for DSO's 10-NN median (optReg/resetPoints).

    :return: (mean at each point, neighbour weight sum at each point)
    """
    flat = pv.long() * Wl + pu.long()
    sv = _splat(flat, val * weight, Hl * Wl).reshape(Hl, Wl)
    sw = _splat(flat, weight, Hl * Wl).reshape(Hl, Wl)
    bv = _box_sum(sv, radius).reshape(-1)[flat]
    bw = _box_sum(sw, radius).reshape(-1)[flat]
    return (torch.where(bw > 0, bv / torch.clamp(bw, min=1e-12),
                        torch.zeros_like(bv)), bw)


def _opt_reg(pu, pv, idepth, iR, is_good, snapped, Hl: int, Wl: int):
    """optReg (CoarseInitializer.cpp:633-666): pull iR toward the good-point
    neighbourhood mean; iR = 1 until snapped."""
    mean, nsum = _neighbor_mean(pu, pv, iR, is_good.float(), Hl, Wl)
    new_iR = torch.where(is_good & (nsum > 2),
                         (1.0 - REG_WEIGHT) * idepth + REG_WEIGHT * mean, iR)
    return torch.where(snapped, new_iR, torch.ones_like(iR))


def _calc_res_gs(T, aff, idepth, is_good, energy_old, iR, lvl_const,
                 snapped):
    """K11: calcResAndGS (CoarseInitializer.cpp:326-585) for all points.

    :param lvl_const: (pu, pv, pcolor, pvalid, planes, Hl, Wl, K) with
        planes the new frame's (img, gx, gy) at the level
    :return: dict with the candidate state and system blocks
    """
    _calc_res_gs.calls += 1
    pu, pv, pcolor, pvalid, planes, Hl, Wl, K = lvl_const
    fx, fy, cx, cy = K
    pat = pattern(pu.device)
    npts = pvalid.float().sum()

    R = T[:3, :3]
    t = T[:3, 3]
    gain = torch.exp(aff[0])

    u8 = pu[:, None] + pat[:, 0]
    v8 = pv[:, None] + pat[:, 1]
    ray = torch.stack([(u8 - cx) / fx, (v8 - cy) / fy, torch.ones_like(u8)],
                      -1)
    pt = (torch.einsum("ij,npj->npi", R, ray)
          + t[None, None, :] * idepth[:, None, None])
    zu = pt[..., 0] / pt[..., 2]
    zv = pt[..., 1] / pt[..., 2]
    Ku = fx * zu + cx
    Kv = fy * zv + cy
    new_id = idepth[:, None] / pt[..., 2]
    inb = (Ku > 1) & (Kv > 1) & (Ku < Wl - 2) & (Kv < Hl - 2) & (new_id > 0)

    hit, gxi, gyi = bilinear_with_grad(*planes, Ku, Kv)
    r = hit - gain * pcolor - aff[1]
    absr = torch.abs(r)
    hw_e = torch.where(absr < HUBER_TH, torch.ones_like(r),
                       _sdiv(HUBER_TH, torch.clamp(absr, min=1e-12)))
    e_pat = hw_e * r * r * (2.0 - hw_e)

    ok_all = inb.all(1)
    energy_new = torch.where(inb, e_pat, torch.zeros_like(e_pat)).sum(1)
    good_new = is_good & ok_all & (energy_new < OUTLIER_E)
    # Bad points contribute their old accepted energy (:365, :459).
    E_photo = torch.where(pvalid, torch.where(good_new, energy_new,
                                              energy_old),
                          torch.zeros_like(energy_new)).sum()

    # Jacobians with sqrt-Huber folding (:427-447)
    hw = torch.where(hw_e < 1.0, torch.sqrt(hw_e), torch.ones_like(hw_e))
    dxdd = (t[0] - t[2] * zu) / pt[..., 2]
    dydd = (t[1] - t[2] * zv) / pt[..., 2]
    dxI = hw * gxi * fx
    dyI = hw * gyi * fy
    dp = torch.stack([
        new_id * dxI,
        new_id * dyI,
        -new_id * (zu * dxI + zv * dyI),
        -zu * zv * dxI - (1 + zv * zv) * dyI,
        (1 + zu * zu) * dxI + zu * zv * dyI,
        -zv * dxI + zu * dyI,
        -hw * gain * pcolor,
        -hw * torch.ones_like(r)], -1)                   # (N, 8, 8)
    dd = dxI * dxdd + dyI * dydd
    rw = hw * r

    steps = _sdiv(1.0, torch.clamp(torch.sqrt((dxdd * fx) ** 2
                                              + (dydd * fy) ** 2), min=1e-10))
    maxstep = torch.where(inb, steps, torch.full_like(steps, 1e10)).amin(1)

    use = (good_new & pvalid)[:, None].float()
    dpw = dp * use[..., None]
    H8 = torch.einsum("npi,npj->ij", dpw, dp)
    b8 = torch.einsum("npi,np->i", dpw, rw)

    Jb = torch.cat([torch.einsum("npi,np->ni", dp, dd),
                    torch.einsum("np,np->n", rw, dd)[:, None],
                    torch.einsum("np,np->n", dd, dd)[:, None]], -1)
    lastH_new = Jb[:, 9]

    # alpha energy + opt (:503-533)
    EAlpha = torch.where(good_new & pvalid, (idepth - 1.0) ** 2,
                         torch.zeros_like(idepth)).sum()
    alpha_energy_raw = ALPHA_W * (EAlpha + (t * t).sum() * npts)
    capped = alpha_energy_raw > ALPHA_K * npts
    alpha_energy = torch.where(capped, ALPHA_K * npts, alpha_energy_raw)
    alpha_opt = torch.where(capped, 0.0, ALPHA_W)
    zero = torch.zeros_like(idepth)
    Jb8 = (Jb[:, 8] + alpha_opt * (idepth - 1.0)
           + torch.where(capped, COUPLING_WEIGHT * (idepth - iR), zero))
    Jb9 = Jb[:, 9] + alpha_opt + torch.where(capped, COUPLING_WEIGHT, 0.0)
    Jb9 = _sdiv(1.0, 1.0 + Jb9)                          # (:558)
    Jb = torch.cat([Jb[:, :8], Jb8[:, None], Jb9[:, None]], -1)

    Jbw = Jb[:, :8] * (use * Jb9[:, None])
    Hsc = torch.einsum("ni,nj->ij", Jbw, Jb[:, :8])
    bsc = torch.einsum("ni,n->i", Jbw, Jb8)

    tlog = se3_log(T[None])[0, :3]
    d3 = torch.arange(3, device=T.device)
    H8 = H8.clone()
    H8[d3, d3] = H8[d3, d3] + alpha_opt * npts
    b8 = torch.cat([b8[:3] + tlog * alpha_opt * npts, b8[3:]])

    return dict(E_photo=E_photo, E_alpha=alpha_energy, good=good_new,
                energy=torch.where(good_new, energy_new, energy_old),
                H=H8, b=b8, Hsc=Hsc, bsc=bsc, Jb=Jb, lastH=lastH_new,
                maxstep=maxstep, snapped=snapped | capped)


_calc_res_gs.calls = 0

# The fields of a level's LM state, in the JAX package's carry order.
_CARRY = ("T", "aff", "idepth", "iR", "good", "energy", "lastH", "snapped",
          "H", "b", "Hsc", "bsc", "Jb", "maxstep", "E_photo", "E_alpha",
          "lam")


def _lm_level_joint(lvl_const, T, aff, idepth, iR, is_good, energy, snapped,
                    max_iter: int):
    """One level of trackFrame's joint LM (CoarseInitializer.cpp:130-245)."""
    pu, pv, pcolor, pvalid, planes, Hl, Wl, K = lvl_const
    dev = T.device
    res0 = _calc_res_gs(T, aff, idepth, is_good, energy, iR, lvl_const,
                        snapped)
    # applyStep (:132): the pre-loop system becomes the accepted state;
    # snapped latches only inside the accept branch (:213).
    s = dict(T=T, aff=aff, idepth=idepth, iR=iR, good=res0["good"],
             energy=res0["energy"], lastH=res0["lastH"], snapped=snapped,
             H=res0["H"], b=res0["b"], Hsc=res0["Hsc"], bsc=res0["bsc"],
             Jb=res0["Jb"], maxstep=res0["maxstep"],
             E_photo=res0["E_photo"], E_alpha=res0["E_alpha"],
             lam=torch.full((), 0.1, device=dev))
    fails = torch.zeros((), dtype=torch.long, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    eye6 = torch.eye(6, device=dev)
    for it in range(max_iter):
        live = (fails < 2) & ~done
        if it and it % CHECK_EVERY == 0 and not bool(live):
            break
        lam = s["lam"]
        f = _sdiv(1.0, 1.0 + lam)
        Hl8 = s["H"] + torch.diag(torch.diag(s["H"])) * lam - s["Hsc"] * f
        bl8 = s["b"] - s["bsc"] * f
        # fixAffine=true (:61): solve the 6-dof pose block only.
        inc6 = -solve_gauss_jordan(Hl8[:6, :6] + 1e-8 * eye6, bl8[:6], 6)
        inc = torch.cat([inc6, torch.zeros(2, device=dev)])
        finite = torch.isfinite(inc).all()
        inc = torch.where(finite, inc, torch.zeros_like(inc))

        T_new = se3_exp(inc[None, :6])[0] @ s["T"]
        aff_new = s["aff"] + inc[6:]
        # doStep (:882-908): idepth back-substitution, pixel-step clamp
        bstep = s["Jb"][:, 8] + s["Jb"][:, :8] @ inc
        step = -bstep * s["Jb"][:, 9] * f
        mstep = torch.clamp(MAX_PIXEL_STEP * s["maxstep"], max=1e10)
        step = torch.minimum(torch.maximum(step, -mstep), mstep)
        id_new = torch.where(s["good"], torch.clamp(s["idepth"] + step,
                                                    1e-3, 50.0), s["idepth"])

        res = _calc_res_gs(T_new, aff_new, id_new, s["good"], s["energy"],
                           s["iR"], lvl_const, s["snapped"])
        # calcEC (:612-631): coupling energy old vs new (0 until snapped)
        use = (res["good"] & pvalid).float()
        zero = torch.zeros((), device=dev)
        ec_old = torch.where(s["snapped"], (use * (s["idepth"] - s["iR"])
                                            ** 2).sum() * COUPLING_WEIGHT,
                             zero)
        ec_new = torch.where(s["snapped"], (use * (id_new - s["iR"])
                                            ** 2).sum() * COUPLING_WEIGHT,
                             zero)
        accept = ((s["E_photo"] + s["E_alpha"] + ec_old
                   > res["E_photo"] + res["E_alpha"] + ec_new) & finite)
        iR_acc = _opt_reg(pu, pv, id_new, s["iR"], res["good"],
                          res["snapped"], Hl, Wl)
        new = dict(T=T_new, aff=aff_new, idepth=id_new, iR=iR_acc,
                   good=res["good"], energy=res["energy"],
                   lastH=res["lastH"],
                   snapped=s["snapped"] | (accept & res["snapped"]),
                   H=res["H"], b=res["b"], Hsc=res["Hsc"], bsc=res["bsc"],
                   Jb=res["Jb"], maxstep=res["maxstep"],
                   E_photo=res["E_photo"], E_alpha=res["E_alpha"])
        # Once the loop's condition is false an iteration changes nothing.
        take = accept & live
        for k, v in new.items():
            s[k] = torch.where(take, v, s[k]) if k != "snapped" else \
                torch.where(live, v, s[k])
        s["lam"] = torch.where(
            live, torch.where(accept, torch.clamp(lam * 0.5, min=1e-4),
                              torch.clamp(lam * 4.0, max=1e4)), lam)
        fails = torch.where(live, torch.where(accept, 0, fails + 1), fails)
        done = done | (live & (torch.sqrt((inc * inc).sum()) <= EPS_INC))
    return (s["T"], s["aff"], s["idepth"], s["iR"], s["good"], s["energy"],
            s["lastH"], s["snapped"])


def initializer_track(state: InitializerState, new_image, fx, fy, cx, cy,
                      img_hw) -> Tuple[InitializerState, torch.Tensor]:
    """trackFrame (CoarseInitializer.cpp:114-276): coarse-to-fine joint LM
    with inter-level propagation; returns (state, done) with done a 0-d
    bool tensor: snapped && frameID > snappedAt + 5."""
    H, W = img_hw
    dims = _level_dims(H, W)
    pyr = build_pyramid(new_image, NUM_LEVELS)
    Ks = pyramid_intrinsics(fx, fy, cx, cy, NUM_LEVELS)

    T, aff, snapped = state.T, state.aff, state.snapped
    idepth, iR = list(state.idepth), list(state.iR)
    good, energy = list(state.is_good), list(state.energy)
    lastH = list(state.last_hessian)

    for lvl in range(NUM_LEVELS - 1, -1, -1):
        Hl, Wl = dims[lvl]
        if lvl < NUM_LEVELS - 1:
            # propagateDown(lvl+1) (:712-739): children take the
            # Hessian-weighted neighbourhood mean of the coarser points.
            sl = lvl + 1
            Hs, Ws = dims[sl]
            pw = torch.where(good[sl] & (lastH[sl] >= 0.1), lastH[sl],
                             torch.zeros_like(lastH[sl]))
            flat_src = state.pv[sl].long() * Ws + state.pu[sl].long()
            sv = _splat(flat_src, iR[sl] * pw, Hs * Ws).reshape(Hs, Ws)
            sw = _splat(flat_src, pw, Hs * Ws).reshape(Hs, Ws)
            bv = _box_sum(sv, 2).reshape(-1)
            bw = _box_sum(sw, 2).reshape(-1)
            cu = (state.pu[lvl] * 0.5).to(torch.int32).clamp(0, Ws - 1)
            cv = (state.pv[lvl] * 0.5).to(torch.int32).clamp(0, Hs - 1)
            flat = cv.long() * Ws + cu.long()
            par_H = bw[flat]
            par_iR = torch.where(par_H > 0, bv[flat]
                                 / torch.clamp(par_H, min=1e-12),
                                 torch.zeros_like(par_H))
            has_par = par_H > 0.1
            was_bad = ~good[lvl] & has_par & state.pvalid[lvl]
            mixed = ((iR[lvl] * lastH[lvl] * 2 + par_iR * par_H)
                     / torch.clamp(lastH[lvl] * 2 + par_H, min=1e-12))
            new_val = torch.where(was_bad, par_iR,
                                  torch.where(good[lvl] & has_par, mixed,
                                              idepth[lvl]))
            idepth[lvl] = new_val
            iR[lvl] = torch.where(was_bad | (good[lvl] & has_par), new_val,
                                  iR[lvl])
            good[lvl] = good[lvl] | was_bad
            lastH[lvl] = torch.where(was_bad, torch.zeros_like(lastH[lvl]),
                                     lastH[lvl])
            iR[lvl] = _opt_reg(state.pu[lvl], state.pv[lvl], idepth[lvl],
                               iR[lvl], good[lvl], snapped, Hl, Wl)
        else:
            # resetPoints, top level (:854-880): reseed bad points from the
            # good-neighbourhood mean.
            mean, nsum = _neighbor_mean(state.pu[lvl], state.pv[lvl],
                                        iR[lvl], good[lvl].float(), Hl, Wl)
            reseed = ~good[lvl] & (nsum > 0) & state.pvalid[lvl]
            idepth[lvl] = torch.where(reseed, mean, idepth[lvl])
            iR[lvl] = torch.where(reseed, mean, iR[lvl])
            good[lvl] = good[lvl] | reseed
        energy[lvl] = torch.zeros_like(energy[lvl])        # resetPoints

        planes = (pyr[lvl]["img"], pyr[lvl]["gx"], pyr[lvl]["gy"])
        lvl_const = (state.pu[lvl], state.pv[lvl], state.pcolor[lvl],
                     state.pvalid[lvl], planes, Hl, Wl, Ks[lvl])
        (T, aff, idepth[lvl], iR[lvl], good[lvl], energy[lvl], lastH[lvl],
         snapped) = _lm_level_joint(lvl_const, T, aff, idepth[lvl], iR[lvl],
                                    good[lvl], energy[lvl], snapped,
                                    MAX_ITERS[lvl])

    # propagateUp fine -> coarse (:243, :668-707): parents take the
    # Hessian-weighted mean of their children's iR (2x2 pool + 3x3 box).
    for sl in range(NUM_LEVELS - 1):
        tl = sl + 1
        Hs, Ws = dims[sl]
        Ht, Wt = dims[tl]
        w_ch = torch.where(good[sl], lastH[sl], torch.zeros_like(lastH[sl]))
        flat_src = state.pv[sl].long() * Ws + state.pu[sl].long()
        sv = _splat(flat_src, iR[sl] * w_ch, Hs * Ws)
        sw = _splat(flat_src, w_ch, Hs * Ws)
        sv = sv.reshape(Hs, Ws)[:Ht * 2, :Wt * 2].reshape(
            Ht, 2, Wt, 2).sum((1, 3))
        sw = sw.reshape(Hs, Ws)[:Ht * 2, :Wt * 2].reshape(
            Ht, 2, Wt, 2).sum((1, 3))
        sv = _box_sum(sv, 1).reshape(-1)
        sw = _box_sum(sw, 1).reshape(-1)
        flat_t = state.pv[tl].long() * Wt + state.pu[tl].long()
        got = sw[flat_t] > 0
        newv = torch.where(got, sv[flat_t] / torch.clamp(sw[flat_t],
                                                         min=1e-12), iR[tl])
        iR[tl] = newv
        idepth[tl] = torch.where(got, newv, idepth[tl])
        good[tl] = good[tl] | (got & state.pvalid[tl])
        iR[tl] = _opt_reg(state.pu[tl], state.pv[tl], idepth[tl], iR[tl],
                          good[tl], snapped, Ht, Wt)

    frame_id = state.frame_id + 1
    zero = torch.zeros_like(state.snapped_at)
    snapped_at = torch.where(snapped, torch.where(state.snapped_at == 0,
                                                  frame_id,
                                                  state.snapped_at), zero)
    done = snapped & (frame_id > snapped_at + 5)
    return state._replace(
        idepth=tuple(idepth), iR=tuple(iR), is_good=tuple(good),
        energy=tuple(energy), last_hessian=tuple(lastH), T=T, aff=aff,
        snapped=snapped, snapped_at=snapped_at, frame_id=frame_id), done
