"""A plain TSDF integrator (the DrFusion semantics the runtime fuses with:
tsdf_volume.cu's IntegrateScanKernel), fed the scans the program fused,
and the gap between two fused volumes.

The volume is a list of 8^3-voxel blocks, allocated where a scan's
truncation band lies (its depths, every ``alloc_stride``-th pixel, at five
offsets through the band), inside an arena of ``table_dim`` blocks an axis
centred on the origin. Each scan updates every voxel of every allocated
block whose nearest pixel (rounded half to even) has a depth in
[min_depth, max_depth): the sdf is the ray distance of the surface less
the voxel's, in the band, and the truncation in free space before it; the
voxel keeps the running mean with its weight, which is clamped at
``max_weight``. ``store`` is the dtype the tsdf and weight are kept in
(float32, or bfloat16 for the control); the arithmetic is float32.
"""

from __future__ import annotations

from typing import Tuple

import torch


class PlainTsdf:
    def __init__(self, cfg: dict, device, store=torch.float32):
        self.vs = cfg["voxel_size"]
        self.b = cfg["block_size"]
        self.trunc = cfg["truncation"]
        self.max_weight = cfg["max_weight"]
        self.min_depth, self.max_depth = cfg["min_depth"], cfg["max_depth"]
        self.stride = cfg["alloc_stride"]
        self.T = cfg["table_dim"]
        self.store = store
        self.device = device
        self.index = torch.full((self.T ** 3,), -1, dtype=torch.int64,
                                device=device)
        self.coords = torch.zeros((0, 3), dtype=torch.int32, device=device)
        self.tsdf = torch.zeros((0, self.b ** 3), dtype=store, device=device)
        self.weight = torch.zeros((0, self.b ** 3), dtype=store,
                                  device=device)

    def fuse(self, depth, K, c2w):
        """One scan: (H, W) depth in metres (0 = none), (3, 3) K and (4, 4)
        camera-to-world, as the program fused them."""
        self._allocate(depth, K, c2w)
        self._integrate(depth, K, c2w)

    def _flat(self, block):
        T = self.T
        shifted = block.long() + T // 2
        inside = torch.all((shifted >= 0) & (shifted < T), dim=-1)
        sx = shifted.clamp(0, T - 1)
        return (sx[..., 0] * T + sx[..., 1]) * T + sx[..., 2], inside

    def _allocate(self, depth, K, c2w):
        s = self.stride
        H, W = depth.shape
        dev = depth.device
        d = depth[::s, ::s].reshape(-1)
        valid = (d >= self.min_depth) & (d <= self.max_depth)
        us = torch.arange(0, W, s, dtype=torch.float32, device=dev)
        vs = torch.arange(0, H, s, dtype=torch.float32, device=dev)
        u = us.repeat(vs.numel())
        v = vs.repeat_interleave(us.numel())
        R, t = c2w[:3, :3], c2w[:3, 3]
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        extent = self.vs * self.b
        blocks = []
        for off in torch.linspace(-self.trunc, self.trunc, 5).tolist():
            z = d + off
            pts = torch.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], -1)
            blocks.append(torch.floor((pts @ R.T + t) / extent)
                          .to(torch.int32))
        flat, inside = self._flat(torch.cat(blocks))
        uniq = torch.unique(flat[valid.repeat(5) & inside])
        new = uniq[self.index[uniq] < 0]
        if new.numel() == 0:
            return
        n = self.coords.shape[0]
        self.index[new] = n + torch.arange(new.numel(), device=dev)
        T = self.T
        self.coords = torch.cat([self.coords, (torch.stack(
            [new // (T * T), (new // T) % T, new % T], -1) - T // 2
        ).to(torch.int32)])
        zeros = torch.zeros((new.numel(), self.b ** 3), dtype=self.store,
                            device=dev)
        self.tsdf = torch.cat([self.tsdf, zeros])
        self.weight = torch.cat([self.weight, zeros])

    def _integrate(self, depth, K, c2w, chunk: int = 8192):
        H, W = depth.shape
        dev = depth.device
        R = c2w[:3, :3].T
        t = -R @ c2w[:3, 3]
        fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        ru = (torch.arange(W, dtype=torch.float32, device=dev)[None, :]
              - cx) / fx
        rv = (torch.arange(H, dtype=torch.float32, device=dev)[:, None]
              - cy) / fy
        ray_norm = torch.sqrt(ru * ru + rv * rv + 1.0).reshape(-1)
        dflat = depth.reshape(-1)
        b = self.b
        li = torch.arange(b ** 3, device=dev)
        lx, ly, lz = ((li % b).float(), ((li // b) % b).float(),
                      (li // (b * b)).float())
        trunc = self.trunc
        for start in range(0, self.coords.shape[0], chunk):
            rows = slice(start, min(start + chunk, self.coords.shape[0]))
            base = self.coords[rows].float() * b
            wx = (base[:, 0:1] + lx) * self.vs
            wy = (base[:, 1:2] + ly) * self.vs
            wz = (base[:, 2:3] + lz) * self.vs
            xc = R[0, 0] * wx + R[0, 1] * wy + R[0, 2] * wz + t[0]
            yc = R[1, 0] * wx + R[1, 1] * wy + R[1, 2] * wz + t[1]
            z = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * wz + t[2]
            z_safe = torch.where(z <= 1e-6, torch.ones_like(z), z)
            u = torch.round(fx * xc / z_safe + cx).to(torch.int64)
            v = torch.round(fy * yc / z_safe + cy).to(torch.int64)
            in_img = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
            pix = torch.where(in_img, v * W + u, torch.zeros_like(u))
            d_px = dflat[pix]
            d_ok = ((d_px > 0) & (d_px >= self.min_depth)
                    & (d_px < self.max_depth))
            surface = d_px * ray_norm[pix]
            dist = torch.sqrt(xc * xc + yc * yc + z * z)
            band = (dist > surface - trunc) & (dist < surface + trunc)
            free = dist < surface - trunc
            update = in_img & d_ok & (band | free)
            sdf = torch.where(band, surface - dist, torch.full_like(z, trunc))
            tc = self.tsdf[rows].float()
            wc = self.weight[rows].float()
            denom = wc + 1.0
            self.tsdf[rows] = torch.where(update, (tc * wc + sdf) / denom,
                                          tc).to(self.store)
            self.weight[rows] = torch.where(
                update, torch.clamp(denom, max=self.max_weight),
                wc).to(self.store)

    def volume(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.coords, self.tsdf.float(), self.weight.float()


def volume_gap(got, ref, table_dim: int, truncation: float,
               max_weight: float) -> float:
    """The mean, over the voxels that either volume has fused (weight > 0),
    of |tsdf - tsdf_ref| / truncation + |weight - weight_ref| / max_weight;
    a block that one volume lacks reads as empty there. Each volume is
    (block coords (N, 3), tsdf (N, b^3), weight (N, b^3))."""
    T = table_dim

    def keys(coords):
        c = coords.long() + T // 2
        return (c[:, 0] * T + c[:, 1]) * T + c[:, 2]

    kg, kr = keys(got[0]), keys(ref[0])
    union = torch.unique(torch.cat([kg, kr]))

    def dense(k, tsdf, weight):
        pos = torch.searchsorted(union, k)
        t = tsdf.new_zeros((union.numel(), tsdf.shape[1]))
        w = weight.new_zeros((union.numel(), weight.shape[1]))
        t[pos], w[pos] = tsdf.float(), weight.float()
        return t, w

    tg, wg = dense(kg, got[1].to(ref[1].device), got[2].to(ref[1].device))
    tr, wr = dense(kr, ref[1], ref[2])
    seen = (wg > 0) | (wr > 0)
    if not bool(seen.any()):
        return float("nan")
    gap = (tg - tr).abs() / truncation + (wg - wr).abs() / max_weight
    return float(gap[seen].double().mean())
