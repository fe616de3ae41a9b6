"""Dense coarse tracker: pyramid photometric LM alignment.

Port of ``tandem_tpu/tracking/coarse_tracker.py`` (the reference's
CoarseTracker, tandem/src/FullSystem/CoarseTracker.cpp:736-937
trackNewestCoarse, :148- makeCoarseDepthL0, and the GPU residual kernels of
libdr/cuda_coarse_tracker). The reference state is a fixed-capacity point
list per pyramid level (DSO's pc_u/pc_v/pc_idepth/pc_color), compacted once
per keyframe from the projected inverse-depth maps; every LM iteration
evaluates the residuals and the 8x8 normal equations of one level's list
for B candidate poses at once. That evaluation is kernel K6
(``ops/track_reduce.py``, CUDA on the card); on the card a level's whole
LM loop, in either weighting, is one launch of the ``track_lm`` kernel
(``ops/track_lm.py``).

Model: a ref pixel (x, y) with inverse depth id maps to the new frame via
q = R K^-1 (x, y, 1) + t id, pixel' = K (q / qz); the photometric residual
r = I_new(pixel') - (a I_ref(x, y) + b) is Huber-weighted with an energy
cutoff (setting_coarseCutoffTH). The LM runs coarse to fine over 6 levels.

TANDEM dense mode: the depth rendered from the global TSDF is reprojected
into the reference keyframe with an occlusion-aware min-z splat and fills
the pixels that have no sparse point (CoarseTracker.cpp:633-733).

Differences from the JAX package, none of them in the arithmetic: the LM
``lax.while_loop`` is a fixed count of steps that do nothing once the loop's
condition is false (on the card, each candidate's loop runs on its own and
the condition is resolved from their recorded states); the new frame's
level planes are read directly (the JAX package's 12-wide corner pack is a
TPU gather trick); the fixed-size point lists are built with a scatter into
a -1-filled buffer (no data-dependent ``nonzero``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..core.pyramid import build_pyramid, pyramid_intrinsics
from ..ops.track_lm import lm_level
from ..ops.track_reduce import (CUTOFF_TH, HUBER_TH, TDIST_DOF,  # noqa: F401
                                track_reduce)

NUM_LEVELS = 6
# DSO's per-level LM iteration caps (CoarseTracker trackNewestCoarse
# maxIterations {10,20,50,50,50,50})
MAX_ITERS = (10, 20, 50, 50, 50, 50)


class CoarseTrackerRef(NamedTuple):
    """Per-level point lists (fine -> coarse), fixed capacity per level;
    the padding is masked by ``pvalid``."""
    pu: Tuple[torch.Tensor, ...]       # (N_l,) pixel x
    pv: Tuple[torch.Tensor, ...]       # (N_l,) pixel y
    pid: Tuple[torch.Tensor, ...]      # (N_l,) inverse depth
    pcolor: Tuple[torch.Tensor, ...]   # (N_l,) ref intensity at the point
    pvalid: Tuple[torch.Tensor, ...]   # (N_l,) bool
    K: Tuple[Tuple[float, float, float, float], ...]  # fx, fy, cx, cy

    def level(self, lvl: int):
        return (self.pu[lvl], self.pv[lvl], self.pid[lvl], self.pcolor[lvl],
                self.pvalid[lvl])


def _level_caps(H: int, W: int, dense: bool):
    """Static per-level point capacities: dense (TANDEM) refs carry a
    stride-3 grid (~H*W/9 points at level 0); sparse DSO refs ~2k active
    points plus dilation growth. Over-capacity maps are decimated evenly."""
    caps = []
    for lvl in range(NUM_LEVELS):
        hw = max((H >> lvl) * (W >> lvl), 1)
        if dense:
            want = (hw // 8 + 4096, 16384, 8192, 8192, 8192, 8192)[lvl]
        else:
            want = (4096, 6144, 8192, 8192, 8192, 8192)[lvl]
        cap = min(hw, want)
        caps.append(-(-cap // 128) * 128)
    return caps


def _compact_level(img, idepth, weight, cap: int):
    """Dense (H, W) maps -> fixed-size point list of the first ``cap`` kept
    pixels in raster order, -1-padded. Evenly decimates when the valid count
    exceeds ``cap``: valid point of rank r is kept iff floor(r*cap/count)
    advances."""
    H, W = img.shape
    flat = (weight > 0).reshape(-1)
    count = flat.long().sum()
    rank = torch.cumsum(flat.long(), 0) - 1
    cnt = torch.clamp(count, min=1)
    keep = flat & ((rank * cap) // cnt != ((rank - 1) * cap) // cnt)
    keep = torch.where(count <= cap, flat, keep)
    # jnp.nonzero(keep, size=cap, fill_value=-1): scatter each kept pixel to
    # its rank; ranks >= cap and dropped pixels land in a spare last slot.
    pos = torch.cumsum(keep.long(), 0) - 1
    dst = torch.where(keep & (pos < cap), pos, torch.full_like(pos, cap))
    idx = torch.full((cap + 1,), -1, dtype=torch.long, device=img.device)
    idx.scatter_(0, dst, torch.arange(H * W, device=img.device))
    idx = idx[:cap]
    ok = idx >= 0
    idxc = torch.clamp(idx, min=0)
    pu = (idxc % W).float()
    pv = (idxc // W).float()
    return pu, pv, idepth.reshape(-1)[idxc], img.reshape(-1)[idxc], ok


def _downsample_idepth(idepth, weight):
    H, W = idepth.shape
    H2, W2 = H // 2, W // 2
    idepth = idepth[:H2 * 2, :W2 * 2]
    weight = weight[:H2 * 2, :W2 * 2]
    i4 = (idepth * weight).reshape(H2, 2, W2, 2).sum((1, 3))
    w4 = weight.reshape(H2, 2, W2, 2).sum((1, 3))
    return (torch.where(w4 > 0, i4 / torch.clamp(w4, min=1e-12),
                        torch.zeros_like(i4)), w4)


def _dilate_fill(idepth, weight):
    """Fill invalid pixels from the 3x3 neighbourhood average (DSO dilates
    coarse idepth maps, makeCoarseDepthL0)."""
    pad_i = torch.nn.functional.pad(idepth * weight, (1, 1, 1, 1))
    pad_w = torch.nn.functional.pad(weight, (1, 1, 1, 1))
    H, W = idepth.shape
    si = torch.zeros_like(idepth)
    sw = torch.zeros_like(weight)
    for dy in range(3):
        for dx in range(3):
            si = si + pad_i[dy:dy + H, dx:dx + W]
            sw = sw + pad_w[dy:dy + H, dx:dx + W]
    fill = (weight <= 0) & (sw > 0)
    out_i = torch.where(fill, si / torch.clamp(sw, min=1e-12), idepth)
    out_w = torch.where(fill, sw / 9.0, weight)
    return out_i, out_w


def splat_depth_to_ref(render_depth, render_c2w, ref_c2w, K, H: int, W: int,
                       stride: int = 3):
    """Occlusion-aware min-z reprojection of a rendered depth map into the
    reference keyframe (CoarseTracker.cpp:683-724).

    :param render_depth: (H, W) depth in the render camera
    :param render_c2w / ref_c2w: (4, 4) camera-to-world poses
    :param K: (3, 3) level-0 intrinsics
    :return: idepth map (H, W), weight map (H, W) with entries on the
        stride grid only
    """
    dev = render_depth.device
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u = torch.arange(W, dtype=torch.float32, device=dev).repeat(H)
    v = torch.arange(H, dtype=torch.float32,
                     device=dev).repeat_interleave(W)
    d = render_depth.reshape(-1)
    ok = d > 0

    x = (u - cx) / fx * d
    y = (v - cy) / fy * d
    pts_w = (torch.stack([x, y, d], -1) @ render_c2w[:3, :3].T
             + render_c2w[:3, 3])
    R = ref_c2w[:3, :3].T
    t = -R @ ref_c2w[:3, 3]
    pts_r = pts_w @ R.T + t
    z = pts_r[:, 2]
    ok = ok & (z > 0.01)
    z_safe = torch.clamp(z, min=1e-6)
    ur = torch.round(fx * pts_r[:, 0] / z_safe + cx).to(torch.int32)
    vr = torch.round(fy * pts_r[:, 1] / z_safe + cy).to(torch.int32)
    ok = ok & (ur >= 0) & (ur < W) & (vr >= 0) & (vr < H)
    flat = torch.where(ok, vr.long() * W + ur.long(),
                       torch.full_like(ur, H * W, dtype=torch.long))

    # Scatter-min into H*W slots plus a drop slot; amin is order-independent.
    zbuf = torch.full((H * W + 1,), float("inf"), device=dev)
    zbuf.scatter_reduce_(0, flat, z_safe, reduce="amin")
    zbuf = zbuf[:H * W].reshape(H, W)
    hit = torch.isfinite(zbuf)

    # Stride grid: only every `stride`-th pixel becomes a tracking point
    gy = torch.arange(H, device=dev) % stride == 0
    gx = torch.arange(W, device=dev) % stride == 0
    use = hit & gy[:, None] & gx[None, :]
    idepth = torch.where(use, 1.0 / torch.where(hit, zbuf,
                                                torch.ones_like(zbuf)),
                         torch.zeros_like(zbuf))
    return idepth, use.float()


def make_tracker_ref(ref_image, fx, fy, cx, cy, sparse_idepth=None,
                     sparse_weight=None, dense_idepth=None,
                     dense_weight=None) -> CoarseTrackerRef:
    """Build the per-level point lists from level-0 idepth/weight maps.

    :param ref_image: (H, W) float intensity
    :param sparse_idepth/weight: (H, W) maps from projected active points
        (makeCoarseDepthL0 analogue); may be None
    :param dense_idepth/weight: (H, W) maps from the TSDF-rendered depth;
        only fill pixels without sparse points
    """
    H, W = ref_image.shape
    if sparse_idepth is None:
        sparse_idepth = torch.zeros_like(ref_image)
        sparse_weight = torch.zeros_like(ref_image)
    idepth0, weight0 = sparse_idepth, sparse_weight
    if dense_idepth is not None:
        fill = (weight0 <= 0) & (dense_weight > 0)
        idepth0 = torch.where(fill, dense_idepth, idepth0)
        weight0 = torch.where(fill, dense_weight, weight0)

    pyr = build_pyramid(ref_image, NUM_LEVELS)
    caps = _level_caps(H, W, dense=dense_idepth is not None)
    lists = []
    cur_i, cur_w = idepth0, weight0
    for lvl in range(NUM_LEVELS):
        if lvl > 0:
            cur_i, cur_w = _downsample_idepth(cur_i, cur_w)
            cur_i, cur_w = _dilate_fill(cur_i, cur_w)
        lists.append(_compact_level(pyr[lvl]["img"], cur_i, cur_w,
                                    caps[lvl]))
    pu, pv, pid, pcol, pval = (tuple(x) for x in zip(*lists))
    return CoarseTrackerRef(pu=pu, pv=pv, pid=pid, pcolor=pcol, pvalid=pval,
                            K=tuple(pyramid_intrinsics(fx, fy, cx, cy,
                                                       NUM_LEVELS)))


def _energy_and_system(T, aff, pts, planes, Klvl, tdist: bool = False):
    """(energy (B,), num (B,), Hm (B, 8, 8), g (B, 8)) of one level: kernel
    K6 in the monocular Huber branch or the RGB-D t-distribution branch."""
    return track_reduce(T, aff, pts, planes, Klvl, tdist)


def _lm_level(T, aff, pts, planes, Klvl, max_iter: int, tdist: bool = False):
    """Batched LM on one level (the JAX package's ``_lm_level``): T (B, 4, 4),
    aff (B, 2) -> (T, aff, e, n, it), ``it`` a 0-d tensor.

    Both branches run ``ops/track_lm.lm_level``: on the card one launch of
    the ``track_lm`` kernel with no host read; on the CPU its plain
    version."""
    return lm_level(T, aff, pts, planes, Klvl, max_iter, tdist)


def rotation_perturbations(scale: float = 0.02):
    """The DSO-style retry list: identity + small rotations about each axis
    and their combinations (trackNewCoarse's perturbed initializations,
    FullSystem.cpp:449-529). Returns (N, 4, 4) numpy float32."""
    deltas = [np.zeros(3)]
    for axis in range(3):
        for sign in (1, -1):
            e = np.zeros(3)
            e[axis] = sign * scale
            deltas.append(e)
    for sx in (1, -1):
        for sy in (1, -1):
            for sz in (1, -1):
                deltas.append(np.array([sx, sy, sz]) * scale * 0.7)
    out = []
    for w in deltas:
        theta = np.linalg.norm(w)
        Wm = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        if theta < 1e-8:
            R = np.eye(3)
        else:
            R = (np.eye(3) + np.sin(theta) / theta * Wm
                 + (1 - np.cos(theta)) / theta ** 2 * (Wm @ Wm))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R.astype(np.float32)
        out.append(T)
    return np.stack(out)


def _planes(level: dict):
    return (level["img"].contiguous(), level["gx"].contiguous(),
            level["gy"].contiguous())


def _track_frame_batched(ref: CoarseTrackerRef, new_image, T_inits,
                         aff_inits, tdist: bool = False):
    """Coarse-to-fine photometric LM over B candidate initializations."""
    new_pyr = build_pyramid(new_image, NUM_LEVELS)
    T, aff = T_inits, aff_inits
    results = {}
    its = []
    for lvl in range(NUM_LEVELS - 1, -1, -1):
        T, aff, e, n, it = _lm_level(T, aff, ref.level(lvl),
                                     _planes(new_pyr[lvl]), ref.K[lvl],
                                     MAX_ITERS[lvl], tdist)
        its.append(it)
        if lvl == 0:
            results["energy"] = e / torch.clamp(n, min=1.0)
            results["num_terms"] = n

    # Flow indicators and the usable share at level 0 (reference calcRes,
    # CoarseTracker.cpp:503-563,620-626).
    # K6's num is the count of _level_residuals' ``good``.
    pts0 = ref.level(0)
    _, n_good, _, _ = track_reduce(T, aff, pts0, _planes(new_pyr[0]),
                                   ref.K[0])
    results.update({
        "T": T, "aff": aff,
        "valid_frac": n_good / torch.clamp(pts0[4].float().sum(), min=1.0),
        "flow": _flow_indicators(T, pts0, ref.K[0]),
    })
    # The levels' step counts, read once per frame.
    return results, [int(i) for i in torch.stack(its).tolist()]


def _flow_indicators(T, pts0, Klvl):
    """The reference's keyframe-flow statistics (calcRes,
    CoarseTracker.cpp:503-563, rs assignment :620-626): mean squared pixel
    displacement under translation-only motion (+t and -t) and under the
    full tracked motion, with the +0.1 denominator guard. Returns (B, 3) =
    [mean shiftT^2, 0, mean shiftRT^2]."""
    pu, pv, idv, _, msk = pts0
    fx, fy, cx, cy = Klvl
    un = (pu - cx) / fx
    vn = (pv - cy) / fy
    ray = torch.stack([un, vn, torch.ones_like(un)], -1)     # (N, 3)
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    ray_rot = torch.einsum("bij,nj->bni", R, ray)             # (B, N, 3)

    def mean_disp2(base, sign):
        q = base + sign * t[:, None, :] * idv[None, :, None]
        qz = q[..., 2]
        ok = msk[None] & (qz > 1e-6)
        qzs = torch.where(qz > 1e-6, qz, torch.ones_like(qz))
        du = fx * q[..., 0] / qzs + cx - pu[None]
        dv = fy * q[..., 1] / qzs + cy - pv[None]
        d2 = torch.where(ok, du * du + dv * dv, torch.zeros_like(du))
        return d2.sum(-1), ok.float().sum(-1)

    ray_b = ray[None].expand(ray_rot.shape)
    s_tp, n_tp = mean_disp2(ray_b, 1.0)
    s_tn, n_tn = mean_disp2(ray_b, -1.0)
    s_fp, n_fp = mean_disp2(ray_rot, 1.0)
    s_fn, n_fn = mean_disp2(ray_rot, -1.0)
    shift_t = (s_tp + s_tn) / (n_tp + n_tn + 0.1)
    shift_rt = (s_fp + s_fn) / (n_fp + n_fn + 0.1)
    return torch.stack([shift_t, torch.zeros_like(shift_t), shift_rt], -1)


def track_frame_multi(ref: CoarseTrackerRef, new_image, T_inits, aff_init,
                      tdist: bool = False):
    """Try several initializations at once (batched coarse-to-fine LM) and
    return the best by level-0 energy (the dict of ``track_frame``)."""
    B = T_inits.shape[0]
    affs = aff_init[None].expand(B, 2).contiguous()
    outs, iters = _track_frame_batched(ref, new_image, T_inits, affs, tdist)
    en = outs["energy"]
    best = torch.argmin(torch.where(torch.isfinite(en), en,
                                    torch.full_like(en, float("inf"))))
    return {**{k: v[best] for k, v in outs.items()}, "lm_iters": iters}


def calc_res_eval(ref: CoarseTrackerRef, new_image, T, aff):
    """Level-0 residual statistics at a fixed pose (the reference's single
    ``calcRes(0, lastToNew, aff, setting_coarseCutoffTH)`` after the dvo
    dense match, CoarseTracker.cpp:960-963). Returns the same dict as
    ``track_frame``, with T/aff passed through."""
    new_pyr = build_pyramid(new_image, NUM_LEVELS)
    pts0 = ref.level(0)
    Tb, affb = T[None].contiguous(), aff[None].contiguous()
    e, n, _, _ = track_reduce(Tb, affb, pts0, _planes(new_pyr[0]),
                              ref.K[0])
    return {
        "T": T, "aff": aff,
        "energy": e[0] / torch.clamp(n[0], min=1.0),
        "num_terms": n[0],
        "valid_frac": n[0] / torch.clamp(pts0[4].float().sum(), min=1.0),
        "flow": _flow_indicators(Tb, pts0, ref.K[0])[0],
    }


def track_frame(ref: CoarseTrackerRef, new_image, T_init, aff_init,
                tdist: bool = False):
    """Coarse-to-fine photometric LM alignment.

    :param new_image: (H, W) float intensity
    :param T_init: (4, 4) initial ref->new pose guess
    :param aff_init: (2,) initial affine (a, b)
    :param tdist: dvo-core's Student-t weighting instead of DSO's Huber +
        cutoff (the RGB-D path, dense_tracking.h:156-160)
    :return: dict with 'T' (4, 4), 'aff' (2,), 'energy' per-residual mean
        at level 0, 'num_terms', 'valid_frac', 'flow' (3,) and 'lm_iters'
        (the LM iteration count of each level, coarse to fine; host ints)
    """
    outs, iters = _track_frame_batched(ref, new_image,
                                       T_init[None].contiguous(),
                                       aff_init[None].contiguous(), tdist)
    return {**{k: v[0] for k, v in outs.items()}, "lm_iters": iters}
