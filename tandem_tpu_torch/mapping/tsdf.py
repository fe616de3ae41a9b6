"""TSDF fusion: block-paged dense voxel grid, integrate and splat render.

Port of ``tandem_tpu/mapping/tsdf.py`` (reference
tandem/libdr/dr_fusion/src/tsdfvh/), full-walk and culled paths. The
reference's voxel hash becomes a dense int32 page table over quantized
block coordinates plus a flat pool of 8^3-voxel blocks:

- allocate_blocks: the truncation band around the depth surface, sampled on
  a strided pixel grid, deduplicated with ``torch.unique`` and appended to
  the pool in ascending table-index order (the JAX package's slot order).
  There is no per-scan bound on new blocks.
- integrate (IntegrateScanKernel, tsdf_volume.cu:436-513): a walk over
  every allocated slot; nearest-pixel projection (round half to even, as
  jnp.round), euclidean ray distances, the weighted sdf/colour mean with
  the weight clamped at max_weight, sdf = surface - voxel in the band and
  +truncation in free space. ``integrate_culled`` does the same over the
  slots of ``visible_slots`` (the reference's per-entry frustum early-out).
- render_depth_splat: per (block, axis, column) the nearest-to-camera sdf
  zero crossing, found by linear interpolation (crossings that straddle a
  block face read the +axis neighbour's first slice), projected into a
  z-buffer with ``scatter_reduce(amin)``; then 2 rounds of 3x3 hole fill.
  It walks every block, the frustum-culled ``visible_slots`` or, per axis,
  the surface-culled ``surface_axis_slots``; the culled paths are exact
  equivalents of the full walk.

On the card, ``integrate``, ``splat_zbuf``'s full walk and ``_fill_holes``
are one launch each of ``csrc/tsdf_fuse.cu`` (each wrapper's ``.launches``
counts them), which culls inside the kernel and needs no slot list or host
read; for CPU tensors they run their plain versions (``integrate_plain``,
``splat_zbuf_plain``, ``fill_holes_plain``), which the kernels equal bit
for bit. The culled walks stay plain on both devices.

Everything is float32; the JAX package's f16 split-precision packs are TPU
gather tricks. Updates happen IN PLACE: ``allocate_blocks``, ``integrate``
and ``grow_volume`` mutate the volume's tensors and return the volume (this
replaces the JAX package's buffer donation); a culled integrate gathers
the visible blocks' rows and scatters them back by slot.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Tuple

import numpy as np
import torch

from ..utils.consts import const, reciprocal32

CHUNK = 8192  # blocks per integrate/render pass (bounds the temporaries)
RAYCAST_FILL_ROUNDS = 4  # 3x3 min fills of the raycast's seed z-buffer
RAYCAST_STEPS = 5        # the raycast's sphere-tracing steps a ray
# The kernels' packed arguments, csrc/tsdf_fuse.cu's IntegrateArgs,
# SplatArgs and FillArgs (keep the layouts in step).
_INTEGRATE_ARGS = struct.Struct("<10Qq3i5f2i")
_SPLAT_ARGS = struct.Struct("<8Qq4i3fi")
_FILL_ARGS = struct.Struct("<2Q4i")


@dataclasses.dataclass(frozen=True)
class TsdfConfig:
    """Mirrors DrFusionOptions (FullSystem.cpp:259-276): 1 cm voxels, 8^3
    blocks, 4 cm truncation, max weight 64."""
    voxel_size: float = 0.01
    block_size: int = 8
    table_dim: int = 160           # blocks per axis; arena = dim*block*voxel m
    pool_size: int = 1 << 16       # current pool capacity in blocks
    pool_max: int = 1 << 18        # growth ceiling for grow_volume
    truncation: float = 0.04
    max_weight: float = 64.0
    min_depth: float = 0.1
    max_depth: float = 10.0
    alloc_stride: int = 2          # band-sampling pixel stride

    @property
    def block_extent(self) -> float:
        return self.voxel_size * self.block_size


@dataclasses.dataclass
class TsdfVolume:
    """Block-paged TSDF volume state (tensors on one device; the counters
    are host integers)."""
    page_table: torch.Tensor    # (T^3,) int32, -1 = unallocated
    block_coords: torch.Tensor  # (pool, 3) int32 signed block coordinates
    tsdf: torch.Tensor          # (pool, B^3) float32
    weight: torch.Tensor        # (pool, B^3) float32
    color: torch.Tensor         # (pool, B^3, 3) float32 [0, 255]
    n_allocated: int = 0
    n_dropped: int = 0          # cumulative pool-full allocation drops


def create_volume(cfg: TsdfConfig, device="cuda") -> TsdfVolume:
    """A zeroed volume on the card, or on ``device`` when the caller asks
    (the CPU tests pass ``"cpu"``). Without a card the default raises."""
    p, b3 = cfg.pool_size, cfg.block_size ** 3
    return TsdfVolume(
        page_table=torch.full((cfg.table_dim ** 3,), -1, dtype=torch.int32,
                              device=device),
        block_coords=torch.zeros((p, 3), dtype=torch.int32, device=device),
        tsdf=torch.zeros((p, b3), device=device),
        weight=torch.zeros((p, b3), device=device),
        color=torch.zeros((p, b3, 3), device=device))


def grow_volume(cfg: TsdfConfig,
                vol: TsdfVolume) -> Tuple[TsdfConfig, TsdfVolume]:
    """Double the block pool (up to pool_max) by zero-padding the pool
    tensors; slots and the page table are unchanged. ``allocate_blocks`` is
    idempotent, so the caller re-runs it on the same scan afterwards."""
    new_pool = min(cfg.pool_size * 2, cfg.pool_max)
    pad = new_pool - cfg.pool_size
    if pad <= 0:
        return cfg, vol

    def grow(t):
        return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])

    vol.block_coords = grow(vol.block_coords)
    vol.tsdf = grow(vol.tsdf)
    vol.weight = grow(vol.weight)
    vol.color = grow(vol.color)
    return dataclasses.replace(cfg, pool_size=new_pool), vol


def copy_volume(vol: TsdfVolume) -> TsdfVolume:
    """A deep copy: every tensor cloned, so that one state can feed two
    in-place updates."""
    return dataclasses.replace(vol, **{f: getattr(vol, f).clone() for f in (
        "page_table", "block_coords", "tsdf", "weight", "color")})


def _table_index(cfg: TsdfConfig, block):
    """block: (..., 3) signed int -> flat int64 table index + validity."""
    T = cfg.table_dim
    shifted = block.long() + T // 2
    valid = torch.all((shifted >= 0) & (shifted < T), dim=-1)
    sx = shifted.clamp(0, T - 1)
    return (sx[..., 0] * T + sx[..., 1]) * T + sx[..., 2], valid


def _unproject(u, v, depth, K):
    """Integer-pixel z-depth unprojection (utils.h GetPoint3d:93-101)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    return torch.stack([(u - cx) * depth / fx, (v - cy) * depth / fy, depth],
                       -1)


def _world_to_cam(cam_to_world):
    R = cam_to_world[:3, :3].T
    return R, -R @ cam_to_world[:3, 3]


def allocate_blocks(cfg: TsdfConfig, vol: TsdfVolume, depth, K,
                    cam_to_world) -> TsdfVolume:
    """Allocate pool blocks for the truncation band around the depth surface
    (in place). The band is sampled on every cfg.alloc_stride-th pixel.

    :param depth: (H, W) metric depth, 0 = invalid
    :param K: (3, 3); cam_to_world: (4, 4)
    """
    stride = cfg.alloc_stride
    H, W = depth.shape
    dev = depth.device
    d = depth[::stride, ::stride].reshape(-1)
    valid = (d >= cfg.min_depth) & (d <= cfg.max_depth)
    us = torch.arange(0, W, stride, dtype=torch.float32, device=dev)
    vs = torch.arange(0, H, stride, dtype=torch.float32, device=dev)
    u = us.repeat(vs.numel())
    v = vs.repeat_interleave(us.numel())
    R, t = cam_to_world[:3, :3], cam_to_world[:3, 3]

    # Band samples half a block apart through [d - trunc, d + trunc].
    blocks = []
    for off in torch.linspace(-cfg.truncation, cfg.truncation, 5).tolist():
        pts_w = _unproject(u, v, d + off, K) @ R.T + t
        blocks.append(torch.floor(pts_w / cfg.block_extent).to(torch.int32))
    flat, in_arena = _table_index(cfg, torch.cat(blocks))
    keep = valid.repeat(5) & in_arena
    uniq = torch.unique(flat[keep])                 # sorted ascending

    new = vol.page_table[uniq] < 0
    cand = uniq[new]
    n_free = cfg.pool_size - vol.n_allocated
    take = cand[:max(n_free, 0)]
    slot = vol.n_allocated + torch.arange(take.numel(), device=dev)
    vol.page_table[take] = slot.to(torch.int32)
    T = cfg.table_dim
    vol.block_coords[slot] = (torch.stack(
        [take // (T * T), (take // T) % T, take % T], -1) - T // 2
    ).to(torch.int32)
    vol.n_dropped += cand.numel() - take.numel()
    vol.n_allocated += take.numel()
    return vol


def _voxel_world(cfg: TsdfConfig, coords, dev):
    """World coordinates of every voxel of ``coords`` blocks, (C, B^3) x3,
    voxel index li = (z * b + y) * b + x."""
    b = cfg.block_size
    li = torch.arange(b ** 3, device=dev)
    lx = (li % b).float()
    ly = ((li // b) % b).float()
    lz = (li // (b * b)).float()
    base = coords.float() * b
    vs = cfg.voxel_size
    return ((base[:, 0:1] + lx) * vs, (base[:, 1:2] + ly) * vs,
            (base[:, 2:3] + lz) * vs)


def _check(name: str, t, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")


def _check_volume(name: str, cfg: TsdfConfig, vol: TsdfVolume) -> None:
    """The volume's layout, on one device: what the kernels index."""
    p, b3 = vol.tsdf.shape[0], cfg.block_size ** 3
    for f, dtype, shape in (("page_table", torch.int32, (cfg.table_dim ** 3,)),
                            ("block_coords", torch.int32, (p, 3)),
                            ("tsdf", torch.float32, (p, b3)),
                            ("weight", torch.float32, (p, b3)),
                            ("color", torch.float32, (p, b3, 3))):
        t = getattr(vol, f)
        _check(f"{name}: {f}", t, dtype, shape)
        if t.device != vol.tsdf.device:
            raise ValueError(f"{name}: {f} on {t.device}, the volume on "
                             f"{vol.tsdf.device}")
    if not 0 <= vol.n_allocated <= p:
        raise ValueError(f"{name}: n_allocated {vol.n_allocated} outside a "
                         f"pool of {p}")


def _check_camera(name: str, vol: TsdfVolume, K, cam_to_world) -> None:
    _check(f"{name}: K", K, torch.float32, (3, 3))
    _check(f"{name}: cam_to_world", cam_to_world, torch.float32, (4, 4))
    for t in (K, cam_to_world):
        if t.device != vol.tsdf.device:
            raise ValueError(f"{name}: inputs on {t.device}, the volume on "
                             f"{vol.tsdf.device}")


def _on_card(name: str, t) -> bool:
    """True for a CUDA tensor (the kernel's), False for a CPU one (the
    plain version's); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def integrate(cfg: TsdfConfig, vol: TsdfVolume, depth, color, K,
              cam_to_world) -> TsdfVolume:
    """Fuse one (depth, color) scan into every allocated block (in place):
    ``integrate_plain`` for CPU tensors, one launch of
    ``tandem_tsdf_integrate`` for CUDA tensors, which updates exactly the
    voxels the plain version updates.

    :param depth: (H, W); color: (H, W, 3) float [0, 255] RGB; K: (3, 3);
        cam_to_world: (4, 4); all float32, contiguous, on the volume's
        device
    """
    _check_volume("integrate", cfg, vol)
    H, W = depth.shape if depth.dim() == 2 else (-1, -1)
    _check("integrate: depth", depth, torch.float32, (H, W))
    _check("integrate: color", color, torch.float32, (H, W, 3))
    _check_camera("integrate", vol, K, cam_to_world)
    if not _on_card("integrate", vol.tsdf):
        return integrate_plain(cfg, vol, depth, color, K, cam_to_world)
    if depth.device != vol.tsdf.device or color.device != vol.tsdf.device:
        raise ValueError("integrate: the scan and the volume on two devices")
    if not vol.n_allocated:
        return vol
    from ..ops._build import launch
    scan = _Scan(depth, color, K, cam_to_world)
    launch("tandem_tsdf_integrate", depth.device, _INTEGRATE_ARGS.pack(
        vol.block_coords.data_ptr(), vol.tsdf.data_ptr(),
        vol.weight.data_ptr(), vol.color.data_ptr(), depth.data_ptr(),
        color.data_ptr(), scan.ray_norm.data_ptr(), K.data_ptr(),
        cam_to_world.data_ptr(), scan.t.data_ptr(), vol.n_allocated, H, W,
        cfg.block_size, cfg.voxel_size, cfg.truncation, cfg.max_weight,
        cfg.min_depth, cfg.max_depth, 0, 0))
    integrate.launches += 1
    return vol


def integrate_plain(cfg: TsdfConfig, vol: TsdfVolume, depth, color, K,
                    cam_to_world) -> TsdfVolume:
    """``integrate`` in torch ops, CHUNK blocks per pass."""
    scan = _Scan(depth, color, K, cam_to_world)
    for start in range(0, vol.n_allocated, CHUNK):
        _integrate_rows(cfg, vol, scan,
                        slice(start, min(start + CHUNK, vol.n_allocated)))
    return vol


def integrate_culled(cfg: TsdfConfig, vol: TsdfVolume, depth, color, K,
                     cam_to_world, slots, n_visible: int) -> TsdfVolume:
    """``integrate`` over the frustum-culled slot list of ``visible_slots``
    (in place): the rows of the visible blocks are gathered by slot,
    updated and scattered back, so the cost scales with the visible
    surface. Equal to ``integrate`` exactly (the per-voxel arithmetic is the
    same, and a culled block cannot be updated, see ``visible_slots``).

    :param n_visible: host count of the visible slots
    """
    scan = _Scan(depth, color, K, cam_to_world)
    for start in range(0, n_visible, CHUNK):
        _integrate_rows(cfg, vol, scan,
                        slots[start:min(start + CHUNK, n_visible)])
    return vol


class _Scan:
    """One scan flattened for the voxel lookups, with the world-to-camera
    transform and the per-pixel ray norm |K^-1 (u, v, 1)| (surface_dist =
    d * norm)."""

    def __init__(self, depth, color, K, cam_to_world):
        H, W = depth.shape
        dev = depth.device
        self.H, self.W = H, W
        self.R, self.t = _world_to_cam(cam_to_world)
        self.fx, self.fy, self.cx, self.cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
        ru = (torch.arange(W, dtype=torch.float32, device=dev)[None, :]
              - self.cx) / self.fx
        rv = (torch.arange(H, dtype=torch.float32, device=dev)[:, None]
              - self.cy) / self.fy
        self.ray_norm = torch.sqrt(ru * ru + rv * rv + 1.0).reshape(-1)
        self.depth = depth.reshape(-1)
        self.color = color.reshape(-1, 3)


def _integrate_rows(cfg: TsdfConfig, vol: TsdfVolume, scan: _Scan, rows):
    """Update the blocks ``rows`` (a slice, or a tensor of slots) in place."""
    R, t, H, W = scan.R, scan.t, scan.H, scan.W
    trunc = cfg.truncation
    wx, wy, wz = _voxel_world(cfg, vol.block_coords[rows], vol.tsdf.device)
    xc = R[0, 0] * wx + R[0, 1] * wy + R[0, 2] * wz + t[0]
    yc = R[1, 0] * wx + R[1, 1] * wy + R[1, 2] * wz + t[1]
    z = R[2, 0] * wx + R[2, 1] * wy + R[2, 2] * wz + t[2]
    z_safe = torch.where(z <= 1e-6, torch.ones_like(z), z)
    u = torch.round(scan.fx * xc / z_safe + scan.cx).to(torch.int64)
    v = torch.round(scan.fy * yc / z_safe + scan.cy).to(torch.int64)
    in_img = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    pix = torch.where(in_img, v * W + u, torch.zeros_like(u))
    d_px = scan.depth[pix]
    d_ok = (d_px > 0) & (d_px >= cfg.min_depth) & (d_px < cfg.max_depth)
    surface_dist = d_px * scan.ray_norm[pix]
    voxel_dist = torch.sqrt(xc * xc + yc * yc + z * z)
    in_band = ((voxel_dist > surface_dist - trunc)
               & (voxel_dist < surface_dist + trunc))
    in_free = voxel_dist < surface_dist - trunc
    update = in_img & d_ok & (in_band | in_free)
    sdf_new = torch.where(in_band, surface_dist - voxel_dist,
                          torch.full_like(z, trunc))

    tsdf_c, weight_c, color_c = vol.tsdf[rows], vol.weight[rows], \
        vol.color[rows]
    denom = weight_c + 1.0
    vol.tsdf[rows] = torch.where(update, (tsdf_c * weight_c + sdf_new)
                                 / denom, tsdf_c)
    vol.color[rows] = torch.where(
        update[..., None],
        (color_c * weight_c[..., None] + scan.color[pix]) / denom[..., None],
        color_c)
    vol.weight[rows] = torch.where(
        update, torch.clamp(denom, max=cfg.max_weight), weight_c)


def _frustum_mask(cfg: TsdfConfig, K, cam_to_world, height: int, width: int,
                  block_coords):
    """Conservative per-block frustum test over (N, 3) block coordinates:
    True for every block that holds a voxel that ``integrate`` can update
    or whose surface points can land in the image (the proof is in the JAX
    package's ``visible_slots``). The block's bounding ball (radius r)
    around its centre is tested:

    - far plane: z - r < max_depth + truncation;
    - image, with the exact first-order margin per axis
      m_u = (fx + |u - cx|) r / (z - r), which carries the obliquity term;
    - near-camera rescue for balls that reach the camera plane: keep if
      |centre| <= (z + r) * ray_norm_max + r.
    """
    centers = (block_coords.float() + 0.5) * cfg.block_extent
    R, t = _world_to_cam(cam_to_world)
    cam = centers @ R.T + t                               # (N, 3)
    r = cfg.block_extent * (3.0 ** 0.5) / 2.0             # bounding radius
    z = cam[:, 2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z_safe = torch.clamp(z, min=1e-3)
    u = fx * cam[:, 0] / z_safe + cx
    v = fy * cam[:, 1] / z_safe + cy
    zr = torch.clamp(z - r, min=1e-3)
    m_u = (fx + torch.abs(u - cx)) * r / zr
    m_v = (fy + torch.abs(v - cy)) * r / zr
    in_depth = z - r < cfg.max_depth + cfg.truncation
    # integrate rounds: u_f in [-0.5, W-0.5) lands on a pixel.
    in_img = ((u + m_u >= -0.5) & (u - m_u <= width - 0.5)
              & (v + m_v >= -0.5) & (v - m_v <= height - 0.5))
    # ray_norm_max over the image: max |([-0.5, W-0.5] - cx) / fx| etc.
    tu = (torch.maximum(cx, width - 1 - cx) + 0.5) / fx
    tv = (torch.maximum(cy, height - 1 - cy) + 0.5) / fy
    norm_max = torch.sqrt(1.0 + tu * tu + tv * tv)
    near = ((z - r <= 0) & (z + r > 0)
            & (torch.sqrt(torch.sum(cam * cam, -1))
               <= (z + r) * norm_max + r))
    return near | ((z - r > 0) & in_depth & in_img)


def _compact(keep, sentinel: int):
    """Indices of the True entries of ``keep`` (N,), compacted to the front
    of an (N,) int64 tensor padded with ``sentinel``, and their count (a
    0-dim tensor: no host sync)."""
    n = keep.shape[0]
    rank = torch.cumsum(keep.long(), 0) - 1
    dst = torch.where(keep, rank, torch.full_like(rank, n))
    out = torch.full((n + 1,), sentinel, dtype=torch.long,
                     device=keep.device)
    out.scatter_(0, dst, torch.arange(n, device=keep.device))
    return out[:n], keep.sum()


def visible_slots(cfg: TsdfConfig, vol: TsdfVolume, K, cam_to_world,
                  height: int, width: int):
    """Frustum-cull the allocated blocks for one camera (the reference's
    IntegrateScanKernel per-entry frustum early-out, tsdf_volume.cu:436-).

    :return: (slots, n_visible): slots (n_allocated,) int64 with the visible
        pool slots compacted to the front and cfg.pool_size padding;
        n_visible a 0-dim int64 tensor (read it with one host sync).
    """
    n = vol.n_allocated
    vis = _frustum_mask(cfg, K, cam_to_world, height, width,
                        vol.block_coords[:n])
    return _compact(vis, cfg.pool_size)


def surface_axis_slots(cfg: TsdfConfig, vol: TsdfVolume, K, cam_to_world,
                       height: int, width: int):
    """Per-axis surface + frustum cull for the splat render camera.

    A (block, axis) pair can emit a surface point only if some column of
    that axis in the block holds valid voxels of both signs, or the block
    and its +axis neighbour hold valid voxels of opposite signs in the same
    column (a face-straddling crossing); and the block passes the frustum
    test. Pairs that fail cannot change the z-buffer, so the axis-culled
    render equals the full walk exactly. Must run after this keyframe's
    integrate: the flags read the fused sdf.

    :return: (slots3, counts3): slots3 (3, n_allocated) int64, per axis the
        kept slots compacted to the front with cfg.pool_size padding;
        counts3 (3,) int64 (read with one host sync).
    """
    b = cfg.block_size
    n = vol.n_allocated
    tsdf_p, weight_p = vol.tsdf[:n], vol.weight[:n]
    coords_p = vol.block_coords[:n]
    valid = weight_p > 0
    view = (n, b, b, b)                                   # (block, z, y, x)
    vp_v = (valid & (tsdf_p >= 0)).reshape(view)
    vn_v = (valid & (tsdf_p <= 0)).reshape(view)
    vis = _frustum_mask(cfg, K, cam_to_world, height, width, coords_p)

    slots3, counts3 = [], []
    # Per axis: the in-block column test, plus a column-exact face term
    # against the +axis neighbour's first slice.
    for axis, dim, lp, ln, fp, fn in (
            (0, 3, vp_v[..., b - 1], vn_v[..., b - 1],
             vp_v[..., 0], vn_v[..., 0]),
            (1, 2, vp_v[:, :, b - 1, :], vn_v[:, :, b - 1, :],
             vp_v[:, :, 0, :], vn_v[:, :, 0, :]),
            (2, 1, vp_v[:, b - 1], vn_v[:, b - 1],
             vp_v[:, 0], vn_v[:, 0])):
        col_cross = vp_v.any(dim) & vn_v.any(dim)
        flag = col_cross.reshape(n, b * b).any(1)
        nb_block = coords_p.clone()
        nb_block[:, axis] += 1
        flat_tab, in_arena = _table_index(cfg, nb_block)
        nb_slot = vol.page_table[flat_tab].long()
        nb_ok = (nb_slot >= 0) & in_arena
        safe = torch.where(nb_ok, nb_slot, torch.zeros_like(nb_slot))
        fp_c, fn_c = fp.reshape(n, b * b), fn.reshape(n, b * b)
        lp_c, ln_c = lp.reshape(n, b * b), ln.reshape(n, b * b)
        face = ((lp_c & fn_c[safe]) | (ln_c & fp_c[safe])).any(1)
        slots, count = _compact(vis & (flag | (nb_ok & face)),
                                cfg.pool_size)
        slots3.append(slots)
        counts3.append(count)
    return torch.stack(slots3), torch.stack(counts3)


# Per world axis a: the (chunk, z, y, x) view dim of a, and for the 64
# columns (o1, o2) the flat voxel index of the neighbour block's first
# slice, the two other axes, and which of (o1, o2) maps to which axis.
def _axis_layout(axis: int, b: int, dev):
    jk = torch.arange(b * b, device=dev)
    o1, o2 = jk // b, jk % b
    return ((3, o1 * (b * b) + o2 * b, 2, 1),    # x gaps: columns (z, y)
            (2, o1 * (b * b) + o2, 2, 0),        # y gaps: columns (z, x)
            (1, o1 * b + o2, 1, 0))[axis], o1, o2  # z gaps: columns (y, x)


def _splat_axis_candidates(cfg: TsdfConfig, vol: TsdfVolume, K, R, t,
                           rows, H: int, W: int, axis: int):
    """Candidate surface points of the blocks ``rows`` (a slice, or a tensor
    of slots) along ONE axis: per
    column, the nearest-to-camera valid sdf sign change, interpolated
    linearly. Returns (flat pixel index, z) for (chunk * b * b) columns,
    flat == H*W where the column has no valid crossing."""
    b = cfg.block_size
    B3 = b ** 3
    vs = cfg.voxel_size
    dev = vol.tsdf.device
    (dim, face_li, col_o1, col_o2), o1, o2 = _axis_layout(axis, b, dev)
    coords = vol.block_coords[rows]
    tsdf_c, weight_c = vol.tsdf[rows], vol.weight[rows]
    chunk = coords.shape[0]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    li = torch.arange(B3, device=dev)
    lx = (li % b).float()
    ly = ((li // b) % b).float()
    lz = (li // (b * b)).float()
    l_o1 = (lx, ly, lz)[col_o1]
    l_o2 = (lx, ly, lz)[col_o2]
    la = (lx, ly, lz)[axis]
    base = coords.float() * b

    # The +axis neighbour's first slice closes the inter-block gap.
    nb_block = coords.clone()
    nb_block[:, axis] += 1
    flat_tab, in_arena = _table_index(cfg, nb_block)
    nb_slot = vol.page_table[flat_tab].long()
    nb_ok = (nb_slot >= 0) & in_arena
    nb_safe = torch.where(nb_ok, nb_slot, torch.zeros_like(nb_slot))
    s_nb = vol.tsdf[nb_safe[:, None], face_li[None]]           # (C, 64)
    w_nb = torch.where(nb_ok[:, None], vol.weight[nb_safe[:, None],
                                                  face_li[None]],
                       torch.zeros_like(s_nb))

    view = (chunk, b, b, b)
    fshape = [chunk, b, b, b]
    fshape[dim] = 1
    s1 = torch.cat([tsdf_c.reshape(view).narrow(dim, 1, b - 1),
                    s_nb.reshape(fshape)], dim).reshape(chunk, B3)
    w1 = torch.cat([weight_c.reshape(view).narrow(dim, 1, b - 1),
                    w_nb.reshape(fshape)], dim).reshape(chunk, B3)
    s0, w0 = tsdf_c, weight_c

    valid = (w0 > 0) & (w1 > 0) & (s0 * s1 <= 0) & ~((s0 == 0) & (s1 == 0))
    denom = s0 - s1
    tt = torch.clamp(s0 / torch.where(denom.abs() < 1e-20,
                                      torch.ones_like(denom), denom), 0.0, 1.0)
    zc = ((R[2, col_o1] * (base[:, col_o1, None] + l_o1)
           + R[2, col_o2] * (base[:, col_o2, None] + l_o2)
           + R[2, axis] * (base[:, axis, None] + la + tt)) * vs + t[2])
    zc = torch.where(valid, zc, torch.full_like(zc, float("inf")))

    # Nearest-to-camera crossing per column (first index on ties).
    red = zc.reshape(view)
    z_out, gmin = torch.min(red, dim=dim)
    t_sel = torch.gather(tt.reshape(view), dim,
                         gmin.unsqueeze(dim)).squeeze(dim)
    gmin = gmin.reshape(chunk, b * b)
    t_sel = t_sel.reshape(chunk, b * b)
    z_out = z_out.reshape(chunk, b * b)
    any_valid = torch.isfinite(z_out) & (z_out > 0)

    p = [None, None, None]
    p[axis] = base[:, axis, None] + gmin.float() + t_sel
    p[col_o1] = base[:, col_o1, None] + o1.float()
    p[col_o2] = base[:, col_o2, None] + o2.float()
    xc = (R[0, 0] * p[0] + R[0, 1] * p[1] + R[0, 2] * p[2]) * vs + t[0]
    yc = (R[1, 0] * p[0] + R[1, 1] * p[1] + R[1, 2] * p[2]) * vs + t[1]
    z_safe = torch.where(z_out <= 1e-6, torch.ones_like(z_out), z_out)
    u = torch.round(fx * xc / z_safe + cx).to(torch.int64)
    v = torch.round(fy * yc / z_safe + cy).to(torch.int64)
    ok = (any_valid & (z_out > cfg.min_depth)
          & (u >= 0) & (u < W) & (v >= 0) & (v < H))
    return (torch.where(ok, v * W + u, torch.full_like(u, H * W)).reshape(-1),
            z_out.reshape(-1))


def render_depth_splat(cfg: TsdfConfig, vol: TsdfVolume, K, cam_to_world,
                       H: int, W: int, slots=None, n_visible: int = None,
                       axis_slots=None, axis_counts=None,
                       fill_rounds: int = 2):
    """Render the model depth at ``cam_to_world`` by splatting per-column
    sdf zero crossings into a z-buffer (occlusion = scatter min), then
    filling holes (``fill_rounds`` rounds of ``_fill_holes``). Returns
    (H, W) depth, 0 where empty.

    By default every allocated block is walked (on the card: one launch,
    which skips the blocks outside the frustum itself). ``slots``/
    ``n_visible`` (``visible_slots`` at this camera) walk only the
    frustum-culled blocks; ``axis_slots``/``axis_counts``
    (``surface_axis_slots``, host counts) splat each axis over only the
    blocks that can cross along it (the backend's CPU route). All three
    give the same depth exactly.
    """
    zbuf = splat_zbuf(cfg, vol, K, cam_to_world, H, W, slots=slots,
                      n_visible=n_visible, axis_slots=axis_slots,
                      axis_counts=axis_counts)
    return _fill_holes(zbuf.reshape(H, W), fill_rounds, from_zbuf=True)


def splat_zbuf(cfg: TsdfConfig, vol: TsdfVolume, K, cam_to_world, H: int,
               W: int, slots=None, n_visible: int = None, axis_slots=None,
               axis_counts=None):
    """The splat render's raw z-buffer before any fill (the JAX package's
    ``_splat_init`` + chunks): (H * W,) nearest crossing depth per pixel,
    inf where none. The block walks are ``render_depth_splat``'s; the full
    walk is one launch of ``tandem_tsdf_splat`` for CUDA tensors and
    ``splat_zbuf_plain`` for CPU ones, the culled walks always the
    latter."""
    if slots is not None or axis_slots is not None:
        return splat_zbuf_plain(cfg, vol, K, cam_to_world, H, W, slots,
                                n_visible, axis_slots, axis_counts)
    _check_volume("splat_zbuf", cfg, vol)
    _check_camera("splat_zbuf", vol, K, cam_to_world)
    if H < 1 or W < 1:
        raise ValueError(f"splat_zbuf: an image of {H} x {W}")
    if not _on_card("splat_zbuf", vol.tsdf):
        return splat_zbuf_plain(cfg, vol, K, cam_to_world, H, W)
    zbuf = torch.full((H * W,), float("inf"), device=vol.tsdf.device)
    if not vol.n_allocated:
        return zbuf
    from ..ops._build import launch
    _, t = _world_to_cam(cam_to_world)
    launch("tandem_tsdf_splat", zbuf.device, _SPLAT_ARGS.pack(
        vol.block_coords.data_ptr(), vol.tsdf.data_ptr(),
        vol.weight.data_ptr(), vol.page_table.data_ptr(), zbuf.data_ptr(),
        K.data_ptr(), cam_to_world.data_ptr(), t.data_ptr(),
        vol.n_allocated, H, W, cfg.block_size, cfg.table_dim,
        cfg.voxel_size, cfg.min_depth, cfg.block_extent, 0))
    splat_zbuf.launches += 1
    return zbuf


def splat_zbuf_plain(cfg: TsdfConfig, vol: TsdfVolume, K, cam_to_world,
                     H: int, W: int, slots=None, n_visible: int = None,
                     axis_slots=None, axis_counts=None):
    """``splat_zbuf`` in torch ops, CHUNK blocks per pass, each pass's
    candidates kept by ``scatter_reduce(amin)``."""
    R, t = _world_to_cam(cam_to_world)
    # One spare slot takes every column without a valid crossing.
    zbuf = torch.full((H * W + 1,), float("inf"), device=vol.tsdf.device)

    def splat(rows, axis):
        flat, z = _splat_axis_candidates(cfg, vol, K, R, t, rows, H, W, axis)
        zbuf.scatter_reduce_(0, flat, z, reduce="amin")

    if axis_slots is not None:
        for axis in range(3):
            c = int(axis_counts[axis])
            for start in range(0, c, CHUNK):
                splat(axis_slots[axis][start:min(start + CHUNK, c)], axis)
    else:
        n = vol.n_allocated if slots is None else n_visible
        for start in range(0, n, CHUNK):
            rows = (slice(start, min(start + CHUNK, n)) if slots is None
                    else slots[start:min(start + CHUNK, n)])
            for axis in range(3):
                splat(rows, axis)
    return zbuf[:H * W]


def _fill_holes(depth, rounds: int = 2, from_zbuf: bool = False):
    """Fill empty pixels (<= 0) from the 3x3 neighbourhood minimum,
    ``rounds`` times (close voxel shells project sparsely):
    ``fill_holes_plain`` for a CPU tensor, one launch of
    ``tandem_tsdf_fill_holes`` a round for a CUDA tensor.

    :param depth: (H, W) float32, contiguous
    :param from_zbuf: ``depth`` is the splat's raw z-buffer, read as 0
        where it is not finite (folded into the first round on the card)
    """
    _check("_fill_holes: depth", depth, torch.float32,
           depth.shape if depth.dim() == 2 else (-1, -1))
    if not _on_card("_fill_holes", depth):
        if from_zbuf:
            depth = torch.where(torch.isfinite(depth), depth,
                                torch.zeros_like(depth))
        return fill_holes_plain(depth, rounds)
    if rounds < 1:
        return (torch.where(torch.isfinite(depth), depth,
                            torch.zeros_like(depth)) if from_zbuf else depth)
    from ..ops._build import launch
    H, W = depth.shape
    for r in range(rounds):
        out = torch.empty_like(depth)
        launch("tandem_tsdf_fill_holes", depth.device, _FILL_ARGS.pack(
            depth.data_ptr(), out.data_ptr(), H, W, int(from_zbuf and r == 0),
            0))
        _fill_holes.launches += 1
        depth = out
    return depth


def fill_holes_plain(depth, rounds: int = 2):
    """``_fill_holes`` in torch ops."""
    H, W = depth.shape
    inf = float("inf")
    for _ in range(rounds):
        p = torch.nn.functional.pad(depth, (1, 1, 1, 1), value=inf)
        p = torch.where(p > 0, p, torch.full_like(p, inf))
        m = torch.full_like(depth, inf)
        for dy in range(3):
            for dx in range(3):
                m = torch.minimum(m, p[dy:dy + H, dx:dx + W])
        depth = torch.where(depth > 0, depth,
                            torch.where(torch.isfinite(m), m,
                                        torch.zeros_like(m)))
    return depth


integrate.launches = 0
splat_zbuf.launches = 0
_fill_holes.launches = 0


def _get_voxels(cfg: TsdfConfig, vol: TsdfVolume, pts_w):
    """Look up (sdf, weight, color) at world points: pts_w (N, 3) -> sdf
    (N,), weight (N,), color (N, 3); unallocated points have weight 0."""
    vox = torch.floor(pts_w * reciprocal32(cfg.voxel_size)).to(torch.int32)
    block = torch.floor(pts_w * reciprocal32(cfg.block_extent)).to(
        torch.int32)
    return _voxels_at(cfg, vol, vox, block)


def _voxels_at(cfg: TsdfConfig, vol: TsdfVolume, vox, block):
    """``_get_voxels`` at integer voxel and block coordinates (N, 3)."""
    b = cfg.block_size
    local = (vox - block * b).clamp(0, b - 1).long()
    flat_tab, in_arena = _table_index(cfg, block)
    slot = vol.page_table[flat_tab]
    allocated = (slot >= 0) & in_arena
    slot_safe = torch.where(allocated, slot, torch.zeros_like(slot)).long()
    li = (local[:, 2] * b + local[:, 1]) * b + local[:, 0]
    w = vol.weight[slot_safe, li]
    return (vol.tsdf[slot_safe, li], torch.where(allocated, w,
                                                 torch.zeros_like(w)),
            vol.color[slot_safe, li])


def _get_interpolated(cfg: TsdfConfig, vol: TsdfVolume, pts_w):
    """Trilinear interpolation with the centre-value fallback for empty
    corners (GetInterpolatedVoxel, tsdf_volume.cu:161-): pts_w (N, 3) ->
    sdf (N,), weight (N,) of the centre voxel, color (N, 3); 0 where the
    centre voxel is empty."""
    vs = cfg.voxel_size
    sdf0, w0, col0 = _get_voxels(cfg, vol, pts_w)
    g = pts_w * reciprocal32(vs)
    frac = g - torch.floor(g)                             # (N, 3)
    sdf_acc = torch.zeros_like(sdf0)
    col_acc = torch.zeros_like(col0)
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                # The point shifted by whole voxels, then back by half of
                # one, in the JAX package's march's order of the roundings.
                off = const((ox * float(np.float32(vs)),
                             oy * float(np.float32(vs)),
                             oz * float(np.float32(vs))), pts_w.device)
                s, w, c = _get_voxels(cfg, vol, pts_w + off - 0.5 * vs)
                use = w > 0
                s = torch.where(use, s, sdf0)
                c = torch.where(use[:, None], c, col0)
                wt = ((frac[:, 0] if ox else 1 - frac[:, 0])
                      * (frac[:, 1] if oy else 1 - frac[:, 1])
                      * (frac[:, 2] if oz else 1 - frac[:, 2]))
                sdf_acc = sdf_acc + wt * s
                col_acc = col_acc + wt[:, None] * c
    zero = torch.zeros_like(sdf_acc)
    return (torch.where(w0 > 0, sdf_acc, zero), w0,
            torch.where(w0[:, None] > 0, col_acc, torch.zeros_like(col_acc)))


def raycast(cfg: TsdfConfig, vol: TsdfVolume, K_and_pose, H: int, W: int):
    """Render depth and colour from a camera by splat-seeded sphere tracing
    (the reference's GenerateRgbDepthKernel, tsdf_volume.cu:600-632, in the
    JAX package's design): the full-walk splat z-buffer of the allocated
    blocks seeds each ray near the surface, RAYCAST_FILL_ROUNDS rounds of
    3x3 min fill close small z-buffer gaps, and each ray then takes
    RAYCAST_STEPS sphere-tracing steps from max(seed - 2 truncation, 0)
    with the reference's hit semantics. Rays with no geometry in reach
    render empty, as the reference's free-space march returns them.

    :param K_and_pose: (K (3, 3), cam_to_world (4, 4)) tensors on the
        volume's device
    :return: depth (H, W) float32 (0 where no hit), colour (H, W, 3)
    """
    K, cam_to_world = K_and_pose
    zbuf = splat_zbuf(cfg, vol, K, cam_to_world, H, W)
    return _raycast_march(cfg, vol, K, cam_to_world, zbuf, H, W)


def _raycast_march(cfg: TsdfConfig, vol: TsdfVolume, K, cam_to_world, zbuf,
                   H: int, W: int):
    """The march of ``raycast`` from the raw z-buffer (H * W,). It reads the
    float32 volume, as the reference does (the JAX package's bf16 march and
    colour tables and its int16 page table are TPU gather-cache tricks)."""
    dev = zbuf.device
    trunc, vs = cfg.truncation, cfg.voxel_size
    u = torch.arange(W, dtype=torch.float32, device=dev).repeat(H)
    v = torch.arange(H, dtype=torch.float32, device=dev).repeat_interleave(W)
    R = cam_to_world[:3, :3]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    rcx = (u - cx) / fx
    rcy = (v - cy) / fy
    ray = torch.stack([R[i, 0] * rcx + R[i, 1] * rcy + R[i, 2]
                       for i in range(3)], -1)            # (H * W, 3)
    origin = cam_to_world[:3, 3]

    # Seed: the splatted surface depth with holes min-filled; holes are
    # the inf entries (not _fill_holes' <= 0 test).
    inf = float("inf")
    splat = zbuf.reshape(H, W)
    for _ in range(RAYCAST_FILL_ROUNDS):
        p = torch.nn.functional.pad(splat, (1, 1, 1, 1), value=inf)
        m = splat
        for dy in range(3):
            for dx in range(3):
                m = torch.minimum(m, p[dy:dy + H, dx:dx + W])
        splat = torch.where(torch.isfinite(splat), splat, m)
    splat = torch.where(torch.isfinite(splat), splat,
                        torch.zeros_like(splat)).reshape(-1)

    zero = torch.zeros_like(splat)
    cur = torch.where(splat > 0, torch.clamp(splat - 2.0 * trunc, min=0.0),
                      zero)
    hit = torch.zeros(H * W, dtype=torch.bool, device=dev)
    for _ in range(RAYCAST_STEPS):
        sdf, w, _ = _get_voxels(cfg, vol, origin + ray * cur[:, None])
        step = torch.where(w > 0, sdf, torch.full_like(sdf, trunc))
        active = ~hit & (cur < cfg.max_depth)
        # The reference advances before its break test, so the depth
        # includes the final sdf step (GenerateRgbDepthKernel:610-621).
        cur = torch.where(active, cur + step, cur)
        hit = hit | (active & (w > 0) & (sdf < vs))
    found = hit & (cur < cfg.max_depth)

    # The hit colour: the trilinear lookup with the centre fallback at the
    # world point on the ray (the corners shift the point, not the depth).
    _, _, col = _get_interpolated(cfg, vol, origin + ray * cur[:, None])
    depth_out = torch.where(found, cur, zero).reshape(H, W)
    color_out = torch.where(found[:, None], col,
                            torch.zeros_like(col)).reshape(H, W, 3)
    return depth_out, color_out
