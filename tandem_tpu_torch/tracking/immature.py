"""Immature-point epipolar tracing and activation refinement.

Port of ``tandem_tpu/tracking/immature.py`` (DSO's ImmaturePoint,
tandem/src/FullSystem/ImmaturePoint.h:46 traceOn, and the GN activation of
FullSystemOptPoint.cpp): every candidate keeps an inverse-depth interval;
each new frame narrows it by a discrete search of N_SAMPLES samples along
the epipolar segment with the 8-pixel pattern SSD; activation refines the
interval centre with GN_ITERS Gauss-Newton steps. ``trace_points`` is K8,
plain PyTorch ops here (XLA ops in the JAX package). The image samples read
the plane directly (the JAX package's packed corner table is a TPU gather
trick); the ``lax.scan`` of the GN steps is a Python loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.se3 import se3_inverse
from ..utils.consts import const
from .ba import _bilinear, _sdiv, pattern

STATUS_UNINIT = 0
STATUS_GOOD = 1
STATUS_OOB = 2
STATUS_OUTLIER = 3
STATUS_SKIPPED = 4

N_SAMPLES = 32     # discrete epipolar samples per trace
GN_ITERS = 3
# Pixel-space match uncertainty mapped back to the idepth interval each
# trace (DSO errorInPixel): small-parallax candidates stay immature.
ERROR_IN_PIXEL = 0.75
MIN_TRACE_QUALITY = 3.0        # setting_minTraceQuality (settings.cpp)
MIN_TRACE_TEST_DIST = 2.0      # px; setting_minTraceTestRadius
MAX_PIXEL_INTERVAL = 8.0       # canActivate lastTracePixelInterval < 8


class ImmaturePoints(NamedTuple):
    uv: torch.Tensor       # (N, 2) pixel in the host frame
    id_min: torch.Tensor   # (N,)
    id_max: torch.Tensor   # (N,)
    color: torch.Tensor    # (N, 8) host pattern intensities
    status: torch.Tensor   # (N,) int32
    valid: torch.Tensor    # (N,) bool
    quality: torch.Tensor  # (N,) secondBest/best SSD of the last wide trace
    last_px: torch.Tensor  # (N,) epipolar px length of the last real search


def _pattern_sample(img, px, py):
    """The 8-pattern intensities around float pixels px, py (any shape):
    (..., 8)."""
    pat = pattern(img.device)
    pu = px[..., None] + pat[:, 0]
    pv = py[..., None] + pat[:, 1]
    return _bilinear(img, pu.reshape(-1), pv.reshape(-1)).reshape(pu.shape)


def make_immature(uv, host_img, id_min: float = 0.01, id_max: float = 10.0):
    """Immature points at the integer pixels uv (N, 2) of the host image."""
    N = uv.shape[0]
    dev = host_img.device
    uv = uv.float()
    return ImmaturePoints(
        uv=uv,
        id_min=torch.full((N,), id_min, device=dev),
        id_max=torch.full((N,), id_max, device=dev),
        color=_pattern_sample(host_img, uv[:, 0], uv[:, 1]),
        status=torch.full((N,), STATUS_UNINIT, dtype=torch.int32,
                          device=dev),
        valid=torch.ones(N, dtype=torch.bool, device=dev),
        quality=torch.zeros(N, device=dev),
        last_px=torch.full((N,), 1e9, device=dev))


def _rays(pts: ImmaturePoints, host_c2w, target_c2w, K):
    fx, fy, cx, cy = K
    T_th = se3_inverse(target_c2w) @ host_c2w
    R, t = T_th[:3, :3], T_th[:3, 3]
    ray = torch.stack([(pts.uv[:, 0] - cx) / fx, (pts.uv[:, 1] - cy) / fy,
                       torch.ones_like(pts.uv[:, 0])], -1)
    return ray @ R.T, t


def trace_points(pts: ImmaturePoints, host_c2w, target_c2w, target_img, K):
    """K8: narrow each point's inverse-depth interval against one target
    frame.

    :param K: (fx, fy, cx, cy) floats
    :return: updated ImmaturePoints
    """
    trace_points.calls += 1
    fx, fy, cx, cy = K
    H, W = target_img.shape
    dev = target_img.device
    Rr, t = _rays(pts, host_c2w, target_c2w, K)

    def project(idep):
        q = Rr + t[None] * idep[:, None]
        qz = torch.clamp(q[:, 2], min=1e-6)
        return fx * q[:, 0] / qz + cx, fy * q[:, 1] / qz + cy

    # Segment endpoints at id_min / id_max; a tiny one is SKIPPED.
    px_min, py_min = project(pts.id_min)
    px_max, py_max = project(pts.id_max)
    seg = torch.stack([px_min - px_max, py_min - py_max], -1)
    seg_len = torch.sqrt((seg * seg).sum(-1))
    skipped = seg_len < 1.5

    # jnp.linspace(0, 1, N_SAMPLES) in float32: iota times a rounded step.
    ids = (torch.arange(N_SAMPLES, dtype=torch.float32, device=dev)
           * const(1.0 / (N_SAMPLES - 1), dev))
    ids[-1] = 1.0
    id_samples = (pts.id_max[:, None]
                  + ids[None, :] * (pts.id_min - pts.id_max)[:, None])

    q = Rr[:, None, :] + t[None, None, :] * id_samples[:, :, None]
    qz = torch.clamp(q[..., 2], min=1e-6)
    px_s = fx * q[..., 0] / qz + cx                     # (N, S)
    py_s = fy * q[..., 1] / qz + cy
    inb = ((px_s > 3) & (px_s < W - 4) & (py_s > 3) & (py_s < H - 4)
           & (q[..., 2] > 1e-6))
    vals = _pattern_sample(target_img, px_s, py_s)     # (N, S, 8)
    ssd = ((vals - pts.color[:, None, :]) ** 2).sum(-1)
    ssd = torch.where(inb, ssd, torch.full_like(ssd, float("inf")))

    best = torch.argmin(ssd, dim=1)
    best_ssd = torch.gather(ssd, 1, best[:, None])[:, 0]
    oob = ~torch.isfinite(ssd).any(1)
    outlier = best_ssd > (12.0 ** 2) * 8

    # Match ambiguity (traceOn's second minimum at least
    # MIN_TRACE_TEST_DIST px from the best; quality kept when untestable).
    bx = torch.gather(px_s, 1, best[:, None])
    by = torch.gather(py_s, 1, best[:, None])
    far = (torch.square(px_s - bx) + torch.square(py_s - by)
           > MIN_TRACE_TEST_DIST ** 2)
    second = torch.where(far, ssd, torch.full_like(ssd, float("inf"))).amin(1)
    quality = torch.where(torch.isfinite(second) & ~skipped & ~oob,
                          second / torch.clamp(best_ssd, min=1e-6),
                          pts.quality)

    # The match +- ERROR_IN_PIXEL px mapped back through the current
    # segment, never narrower than +-1 sample.
    step = 1.0 / (N_SAMPLES - 1)
    radius = torch.clamp(_sdiv(ERROR_IN_PIXEL, torch.clamp(seg_len,
                                                           min=1e-6)),
                         min=step)
    frac = best.float() * step
    lo = torch.clamp(frac - radius, 0.0, 1.0)
    hi = torch.clamp(frac + radius, 0.0, 1.0)
    new_max = pts.id_max + lo * (pts.id_min - pts.id_max)
    new_min = pts.id_max + hi * (pts.id_min - pts.id_max)
    id_min_new = torch.minimum(new_min, new_max)
    id_max_new = torch.maximum(new_min, new_max)

    good = pts.valid & ~skipped & ~oob & ~outlier
    status = torch.where(oob, STATUS_OOB,
                         torch.where(outlier, STATUS_OUTLIER,
                                     STATUS_GOOD)).to(torch.int32)
    # SKIPPED keeps the previous interval and status (IPS_SKIPPED).
    status = torch.where(skipped, pts.status, status)
    return pts._replace(
        id_min=torch.where(good, id_min_new, pts.id_min),
        id_max=torch.where(good, id_max_new, pts.id_max),
        status=torch.where(pts.valid, status, pts.status),
        quality=torch.where(pts.valid, quality, pts.quality),
        last_px=torch.where(good, seg_len, pts.last_px))


trace_points.calls = 0


def activate_points(pts: ImmaturePoints, host_c2w, target_c2w, target_img,
                    K):
    """GN refinement of idepth at the interval centre against one target
    (optimizeImmaturePoint) and DSO's canActivate test.

    :return: (idepth (N,), ok (N,) bool)
    """
    fx, fy, cx, cy = K
    H, W = target_img.shape
    Rr, t = _rays(pts, host_c2w, target_c2w, K)

    def energy(idep):
        qq = Rr + t[None] * idep[:, None]
        qz = torch.clamp(qq[:, 2], min=1e-6)
        px = fx * qq[:, 0] / qz + cx
        py = fy * qq[:, 1] / qz + cy
        r = _pattern_sample(target_img, px, py) - pts.color
        inb = (px > 3) & (px < W - 4) & (py > 3) & (py < H - 4)
        return r, inb

    idep = 0.5 * (pts.id_min + pts.id_max)
    for _ in range(GN_ITERS):
        r, inb = energy(idep)
        eps = 1e-4
        r2, _ = energy(idep + eps)
        Jd = (r2 - r) / eps
        H_ = (Jd * Jd).sum(-1) + 1e-6
        g_ = (Jd * r).sum(-1)
        new = torch.clamp(idep - g_ / H_, 1e-4, 1e3)
        idep = torch.where(inb, new, idep)
    r, inb = energy(idep)
    e = (r * r).sum(-1)
    ok = (pts.valid & inb & (e < (12.0 ** 2) * 8)
          & (pts.status != STATUS_OUTLIER) & (pts.status != STATUS_UNINIT)
          & (pts.quality > MIN_TRACE_QUALITY)
          & (pts.last_px < MAX_PIXEL_INTERVAL) & (idep > 1e-3))
    return idep, ok
