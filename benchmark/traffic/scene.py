"""The benchmark's scene and camera path, rendered on the device.

A copy, in torch, of the analytic room of ``tests/fixtures/make_replica_mini.py``
(three textured planes and two free-standing boxes, ray-cast with exact
depth): the back wall at z = 3.2 m, an angled side wall, the floor 0.9 m below
the camera, and the trajectory scene's two boxes, which give the monocular
initializer and the BA non-coplanar structure. The decor is the fixture's
quantised value noise, its lattice shifted by a traffic file's
``decor_seed``. A run's seed picks where on the periodic path the run
starts (the drivers), so every seed sees the same frames, in another
order.

Everything is float64 on the device and rendered in a few large calls, so a
whole period of frames costs well under a second on the card. The images are
box-filtered from 3 x 3 rays a pixel (``SUPERSAMPLE``) and the depth is the
centre ray's, as the fixture renders them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PLANES = ((0.0, 0.0, 1.0, 3.2),      # back wall: n . p = d
          (-0.45, 0.0, 1.0, 2.2),    # angled side wall
          (0.0, 1.0, 0.0, 0.9))      # floor
BOXES = (((0.35, 0.25, 1.70), (0.85, 0.90, 2.15)),
         ((-1.05, 0.45, 2.30), (-0.55, 0.90, 2.75)))
PALETTE = ((0.82, 0.78, 0.70), (0.35, 0.42, 0.55), (0.62, 0.30, 0.25),
           (0.28, 0.50, 0.33), (0.88, 0.85, 0.60))
SUPERSAMPLE = 3
# OpenCV 5's fixed-point BGR -> grey (what a camera's grey stream holds).
GREY_WEIGHTS = (3735, 19235, 9798)


def texture_offset(seed: int) -> tuple:
    """A decor seed's shift of the noise lattice (metres)."""
    rng = np.random.default_rng(seed)
    return tuple(float(x) for x in rng.uniform(0.0, 50.0, 3))


def _hash3(i, j, k):
    s = torch.sin(i * 12.9898 + j * 78.233 + k * 37.719 + 0.5) * 43758.5453
    return s - torch.floor(s)


def _value_noise(p, freq: float):
    q = p * freq
    q0 = torch.floor(q)
    f = q - q0
    f = f * f * (3.0 - 2.0 * f)
    out = torch.zeros_like(q[..., 0])
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                w = ((f[..., 0] if di else 1 - f[..., 0])
                     * (f[..., 1] if dj else 1 - f[..., 1])
                     * (f[..., 2] if dk else 1 - f[..., 2]))
                out = out + w * _hash3(q0[..., 0] + di, q0[..., 1] + dj,
                                       q0[..., 2] + dk)
    return out


def _texture(p):
    """RGB in [0, 1] of world points p (..., 3): quantised flat regions with
    sharp borders, sub-region detail and soft shading (the fixture's)."""
    n1 = _value_noise(p, 2.3)
    n2 = _value_noise(p + 53.7, 5.9)
    n3 = _value_noise(p + 91.1, 13.7)
    region = torch.remainder(torch.floor(n1 * 5 + n2 * 2.2), 5).long()
    palette = torch.tensor(PALETTE, dtype=p.dtype, device=p.device)
    rgb = palette[region]
    rgb = rgb * (0.82 + 0.18 * (n3 > 0.55).to(p.dtype))[..., None]
    rgb = rgb * (0.75 + 0.25 * _value_noise(p + 7.7, 0.9))[..., None]
    return torch.clamp(rgb, 0.02, 0.98)


def _ray_hits(origin, dirs):
    """Distance along each ray (..., 3) to the nearest surface (inf where
    nothing is hit)."""
    tmin = torch.full(dirs.shape[:-1], math.inf, dtype=dirs.dtype,
                      device=dirs.device)
    for nx, ny, nz, d in PLANES:
        n = torch.tensor((nx, ny, nz), dtype=dirs.dtype, device=dirs.device)
        denom = dirs @ n
        ti = (d - origin @ n) / torch.where(denom.abs() < 1e-12,
                                            torch.full_like(denom, 1e-12),
                                            denom)
        tmin = torch.minimum(tmin, torch.where((denom > 1e-9) & (ti > 0.05),
                                               ti, math.inf))
    for lo, hi in BOXES:
        lo = torch.tensor(lo, dtype=dirs.dtype, device=dirs.device)
        hi = torch.tensor(hi, dtype=dirs.dtype, device=dirs.device)
        safe = torch.where(dirs.abs() < 1e-12, torch.full_like(dirs, 1e-12),
                           dirs)
        t0 = (lo - origin[..., None, None, :]) / safe
        t1 = (hi - origin[..., None, None, :]) / safe
        tn = torch.minimum(t0, t1).amax(-1)
        tf = torch.maximum(t0, t1).amin(-1)
        hit = (tn < tf) & (tn > 0.05)
        tmin = torch.minimum(tmin, torch.where(hit, tn, math.inf))
    return tmin


class Camera:
    """Pinhole intrinsics of the rendered frames."""

    def __init__(self, width: int, height: int, fx: float, fy: float):
        self.width, self.height = width, height
        self.fx, self.fy = fx, fy
        self.cx, self.cy = (width - 1) / 2.0, (height - 1) / 2.0

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0, self.cx], [0, self.fy, self.cy],
                         [0, 0, 1]], np.float32)


def _render_rays(c2w, cam: Camera, ss: int, offset, device):
    """(rgb (h*ss, w*ss, 3) in [0, 1], z-depth (h*ss, w*ss)) of one pose."""
    w, h = cam.width * ss, cam.height * ss
    fx, fy = cam.fx * ss, cam.fy * ss
    cx, cy = (cam.cx + 0.5) * ss - 0.5, (cam.cy + 0.5) * ss - 0.5
    f64 = torch.float64
    vs, us = torch.meshgrid(torch.arange(h, dtype=f64, device=device),
                            torch.arange(w, dtype=f64, device=device),
                            indexing="ij")
    dirs_cam = torch.stack([(us - cx) / fx, (vs - cy) / fy,
                            torch.ones_like(us)], -1)
    c2w = torch.as_tensor(np.asarray(c2w, np.float64), device=device)
    R, t = c2w[:3, :3], c2w[:3, 3]
    dirs = dirs_cam @ R.T
    tmin = _ray_hits(t, dirs)
    hit = torch.isfinite(tmin)
    tz = torch.where(hit, tmin, torch.zeros_like(tmin))
    pts = t + dirs * tz[..., None]
    rgb = _texture(pts + torch.tensor(offset, dtype=f64, device=device))
    rgb = torch.where(hit[..., None], rgb, torch.zeros_like(rgb))
    return rgb, tz * dirs_cam[..., 2]


def render(c2w, cam: Camera, offset=(0.0, 0.0, 0.0), device="cpu",
           ss: int = SUPERSAMPLE):
    """One frame: (bgr uint8 (H, W, 3), grey uint8 (H, W), depth float32
    (H, W) in metres, 0 where no surface), as device tensors."""
    rgb, depth = _render_rays(c2w, cam, ss, offset, device)
    h, w = cam.height, cam.width
    # As the fixture: each ray truncated to uint8, then the box filter.
    rgb = torch.floor(rgb * 255.0).reshape(h, ss, w, ss, 3).mean((1, 3))
    bgr = torch.clamp(torch.round(rgb), 0, 255).flip(-1).to(torch.uint8)
    depth = depth.reshape(h, ss, w, ss)[:, ss // 2, :, ss // 2]
    return bgr, grey(bgr), depth.to(torch.float32)


def grey(bgr):
    """uint8 BGR (..., 3) -> uint8 grey, OpenCV 5's fixed point."""
    b, g, r = (bgr[..., i].to(torch.int32) for i in range(3))
    wb, wg, wr = GREY_WEIGHTS
    return ((wb * b + wg * g + wr * r + 16384) >> 15).to(torch.uint8)


def rotation(yaw: float, pitch: float, roll: float) -> np.ndarray:
    """The fixture's R = Ry(yaw) Rx(pitch) Rz(roll)."""
    cy_, sy_ = math.cos(yaw), math.sin(yaw)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cr, sr = math.cos(roll), math.sin(roll)
    Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]])
    return Ry @ Rx @ Rz


def path_pose(i: int, p: dict) -> np.ndarray:
    """c2w (4, 4) float64 of frame ``i`` of the periodic hand-held path that
    the traffic file ``p`` describes: an ellipse in x-z with a vertical bob,
    a yaw sway and a small pitch and roll wobble, all with the period
    ``p["period"]`` frames."""
    th = 2.0 * math.pi * (i % p["period"]) / p["period"]
    c2w = np.eye(4)
    c2w[:3, :3] = rotation(
        p["yaw"] * math.sin(th) + p["yaw_wobble"] * math.sin(3 * th),
        p["pitch"] + p["pitch_wobble"] * math.sin(2 * th),
        p["roll_wobble"] * math.sin(5 * th))
    c2w[:3, 3] = (p["x_radius"] * math.sin(th),
                  p["y"] + p["bob"] * math.sin(4 * th),
                  p["z_radius"] * (1.0 - math.cos(th)) + p["z"])
    return c2w


def path_step(p: dict) -> tuple:
    """Largest translation (m) and rotation (deg) between consecutive frames
    of the path."""
    dt, dr = 0.0, 0.0
    for i in range(p["period"]):
        a, b = path_pose(i, p), path_pose(i + 1, p)
        dt = max(dt, float(np.linalg.norm(b[:3, 3] - a[:3, 3])))
        rel = a[:3, :3].T @ b[:3, :3]
        ang = math.acos(max(-1.0, min(1.0, (np.trace(rel) - 1) / 2)))
        dr = max(dr, math.degrees(ang))
    return dt, dr


def render_frames(indices, p: dict, cam: Camera, offset, device):
    """Frames ``indices`` of the path: bgr (N, H, W, 3) and grey (N, H, W)
    uint8 on the host, depth (N, H, W) float32 on ``device``."""
    bgrs, greys, depths = [], [], []
    for i in indices:
        bgr, g, d = render(path_pose(i, p), cam, offset, device)
        bgrs.append(bgr)
        greys.append(g)
        depths.append(d)
    return (torch.stack(bgrs).cpu().numpy(), torch.stack(greys).cpu().numpy(),
            torch.stack(depths))
