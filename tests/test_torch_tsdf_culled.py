"""The culled TSDF paths of the port and the culled backend.

The cases of tests/test_tsdf.py for the culled paths (facing, away-facing
and adversarial cameras, the frustum- and surface-culled renders, growth
then cull) on the port at the same small size (60x80 depth, 2 cm voxels, a
64^3 page table): every culled integrate and render equals the port's full
walk exactly (torch.equal). Against the JAX package: the same visible and
per-axis surface block sets (compared by block coordinates, slot order may
differ), and the culled backend's rendered depth within 1e-3 m on >= 99%
of pixels (as tests/test_torch_backend.py).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tandem_tpu.mapping import tsdf as jt
from tandem_tpu.pipeline.backend import TandemBackend as JTandemBackend
from tandem_tpu_torch.mapping import tsdf as tt
from tandem_tpu_torch.pipeline.backend import TandemBackend

H, W = 60, 80
KW = dict(voxel_size=0.02, table_dim=64, pool_size=4096, truncation=0.08,
          max_depth=8.0)
CFG = tt.TsdfConfig(**KW)
K = np.array([[70.0, 0, (W - 1) / 2], [0, 70.0, (H - 1) / 2], [0, 0, 1]],
             np.float32)
K_WIDE = np.array([[25.0, 0, (W - 1) / 2], [0, 25.0, (H - 1) / 2],
                   [0, 0, 1]], np.float32)   # tan(half-FOV) ~ 1.6
T_ = torch.from_numpy


def pose_at(tx, ty, tz):
    p = np.eye(4, dtype=np.float32)
    p[:3, 3] = [tx, ty, tz]
    return p


def _wall(z=2.0):
    return np.full((H, W), z, np.float32)


def _curved():
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    return (2.0 + 0.5 * np.sin(u * 0.15) * np.cos(v * 0.12)).astype(
        np.float32)


def _color(rgb=(90.0, 120.0, 200.0)):
    return np.broadcast_to(np.array(rgb, np.float32), (H, W, 3)).copy()


def _fused(depth, poses, cfg=CFG):
    vol = tt.create_volume(cfg, "cpu")
    for p in poses:
        tt.allocate_blocks(cfg, vol, T_(depth), T_(K), T_(p))
        tt.integrate(cfg, vol, T_(depth), T_(_color()), T_(K), T_(p))
    return vol


def _copy(vol):
    return dataclasses.replace(vol, **{f: getattr(vol, f).clone() for f in (
        "page_table", "block_coords", "tsdf", "weight", "color")})


def _assert_same_volume(a, b):
    for f in ("tsdf", "weight", "color"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _culled_vs_full(vol, depth, Kc, pc):
    slots, n_vis = tt.visible_slots(CFG, vol, T_(Kc), T_(pc), H, W)
    n_vis = int(n_vis)
    args = (T_(depth), T_(_color((200.0, 60.0, 30.0))), T_(Kc), T_(pc))
    full = tt.integrate(CFG, _copy(vol), *args)
    cull = tt.integrate_culled(CFG, _copy(vol), *args, slots, n_vis)
    _assert_same_volume(full, cull)
    return n_vis, cull


def test_integrate_culled_matches_full():
    """tests/test_tsdf.py::test_integrate_culled_matches_full on the port:
    the facing camera sees nearly every block; an away-facing camera sees
    almost none and integrates nothing."""
    depth = _wall()
    vol = tt.allocate_blocks(CFG, tt.create_volume(CFG, "cpu"), T_(depth),
                             T_(K), T_(np.eye(4, dtype=np.float32)))
    n_alloc = vol.n_allocated
    n_vis, cull = _culled_vs_full(vol, depth, K, np.eye(4, dtype=np.float32))
    assert 0.9 * n_alloc < n_vis <= n_alloc
    away = np.eye(4, dtype=np.float32)
    away[:3, :3] = np.diag([1.0, -1.0, -1.0])   # 180 degrees about x
    n_away, after = _culled_vs_full(cull, depth, K, away)
    assert n_away < 0.05 * n_alloc
    assert after.weight.max() == 1.0            # no double integration


@pytest.mark.parametrize("case", [
    (K, (0.0, 0.0, 1.98)),      # inside the truncation band
    (K, (0.0, 0.0, 2.02)),      # inside, just past the surface
    (K, (0.03, -0.02, 1.995)),  # inside, off-centre
    (K_WIDE, (0.0, 0.0, 1.0)),  # wide FOV, oblique blocks
    (K_WIDE, (0.5, 0.3, 1.9)),  # wide FOV from inside the band
])
def test_integrate_culled_adversarial_poses(case):
    """Adversarial cameras of tests/test_tsdf.py: culled == full exactly."""
    Kc, t = case
    vol = _fused(_wall(), [np.eye(4, dtype=np.float32)])
    _culled_vs_full(vol, _wall(), Kc, pose_at(*t))


@pytest.mark.parametrize("case", [
    (K, (0.0, 0.0, 0.0)), (K, (0.3, -0.2, 0.5)),
    (K_WIDE, (0.0, 0.0, 1.0)), (K, (0.0, 0.0, 1.98))])
def test_splat_culled_matches_full(case):
    Kc, t = case
    vol = _fused(_wall(), [np.eye(4, dtype=np.float32)])
    pc = T_(pose_at(*t))
    slots, n_vis = tt.visible_slots(CFG, vol, T_(Kc), pc, H, W)
    full = tt.render_depth_splat(CFG, vol, T_(Kc), pc, H, W)
    cull = tt.render_depth_splat(CFG, vol, T_(Kc), pc, H, W, slots=slots,
                                 n_visible=int(n_vis))
    assert torch.equal(full, cull)


def test_splat_axis_culled_matches_full():
    """A curved surface fused from two cameras (face-straddling crossings,
    mixed weights): the per-axis surface-culled render equals the full walk
    and culls some (block, axis) pairs."""
    p2 = pose_at(0.15, -0.1, 0.3)
    vol = _fused(_curved(), [np.eye(4, dtype=np.float32), p2])
    n_alloc = vol.n_allocated
    total = 0
    for t in ((0.0, 0.0, 0.0), (0.3, -0.2, 0.5), (0.0, 0.0, 1.9)):
        pc = T_(pose_at(*t))
        slots3, counts3 = tt.surface_axis_slots(CFG, vol, T_(K), pc, H, W)
        counts = counts3.tolist()
        total += sum(counts)
        full = tt.render_depth_splat(CFG, vol, T_(K), pc, H, W)
        cull = tt.render_depth_splat(CFG, vol, T_(K), pc, H, W,
                                     axis_slots=slots3, axis_counts=counts)
        assert torch.equal(full, cull)
        assert sum(counts) < 3 * n_alloc
    assert total > 0


def test_grow_then_axis_culled_splat():
    """After grow_volume the pool is larger; the surface-culled render stays
    exact on the grown volume."""
    cfg = tt.TsdfConfig(**dict(KW, pool_size=256, pool_max=8192))
    depth, pose = _curved(), np.eye(4, dtype=np.float32)
    vol = tt.allocate_blocks(cfg, tt.create_volume(cfg, "cpu"), T_(depth),
                             T_(K), T_(pose))
    while vol.n_dropped:
        prev = vol.n_dropped
        cfg, vol = tt.grow_volume(cfg, vol)
        vol.n_dropped = 0
        tt.allocate_blocks(cfg, vol, T_(depth), T_(K), T_(pose))
        assert vol.n_dropped < prev or cfg.pool_size == cfg.pool_max
    tt.integrate(cfg, vol, T_(depth), T_(_color()), T_(K), T_(pose))
    assert vol.n_allocated > 256
    slots3, counts3 = tt.surface_axis_slots(cfg, vol, T_(K), T_(pose), H, W)
    full = tt.render_depth_splat(cfg, vol, T_(K), T_(pose), H, W)
    cull = tt.render_depth_splat(cfg, vol, T_(K), T_(pose), H, W,
                                 axis_slots=slots3,
                                 axis_counts=counts3.tolist())
    assert torch.equal(full, cull)


def _coords(coords, slots, n):
    return {tuple(c) for c in np.asarray(coords)[np.asarray(slots)[:n]]
            .tolist()}


def test_culling_matches_jax():
    """visible_slots and surface_axis_slots select the same blocks as the
    JAX package's, on the same fused scene."""
    p2 = pose_at(0.15, -0.1, 0.3)
    depth = _curved()
    cfg_j = jt.TsdfConfig(**KW)
    vj = jt.create_volume(cfg_j)
    for p in (np.eye(4, dtype=np.float32), p2):
        vj = jt.allocate_blocks(cfg_j, vj, jnp.asarray(depth),
                                jnp.asarray(K), jnp.asarray(p))
        vj = jt.integrate(cfg_j, vj, jnp.asarray(depth),
                          jnp.asarray(_color()), jnp.asarray(K),
                          jnp.asarray(p))
    vt = _fused(depth, [np.eye(4, dtype=np.float32), p2])
    n = vt.n_allocated
    assert int(vj.n_allocated) == n
    n_pad = -(-n // 1024) * 1024
    for Kc, t in ((K, (0.3, -0.2, 0.5)), (K_WIDE, (0.0, 0.0, 1.0)),
                  (K, (0.0, 0.0, 1.9))):
        pc = pose_at(*t)
        sj, nj = jt.visible_slots(cfg_j, vj, jnp.asarray(Kc),
                                  jnp.asarray(pc), H, W)
        st, nt = tt.visible_slots(CFG, vt, T_(Kc), T_(pc), H, W)
        assert int(nt) == int(nj)
        assert (_coords(vt.block_coords, st, int(nt))
                == _coords(vj.block_coords, sj, int(nj)))
        s3j, c3j = jt.surface_axis_slots(cfg_j, vj, jnp.asarray(Kc),
                                         jnp.asarray(pc), H, W, n_pad)
        s3t, c3t = tt.surface_axis_slots(CFG, vt, T_(Kc), T_(pc), H, W)
        assert c3t.tolist() == [int(c) for c in np.asarray(c3j)]
        for a in range(3):
            assert (_coords(vt.block_coords, s3t[a], int(c3t[a]))
                    == _coords(vj.block_coords, s3j[a], int(c3j[a])))


class _DepthRunner:
    """A stand-in MVSNet runner that hands back prescribed depth maps, so
    both backends fuse the same depths."""
    view_num = 7

    def __init__(self, depths, to_device):
        self.depths = list(depths)
        self.to_device = to_device
        self.device = "cpu"
        self._out = None

    def call_async(self, bgrs, cam_to_worlds, K, depth_min, depth_max,
                   discard_percentage=10.0):
        self._out = self.depths.pop(0)

    def get_result(self, device=False):
        return {"depth": self.to_device(self._out), "confidence": None}

    def device_ready(self):
        return True

    ready = device_ready


def _turn(deg):
    a = np.deg2rad(deg)
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                 [-np.sin(a), 0, np.cos(a)]]
    return p


def test_backend_culled_fusion_matches_jax_and_full():
    """Three keyframes: a wall, the camera turned 80 degrees onto a small
    patch (most of the map leaves the frustum, so the backend takes the
    culled integrate), then back. The port's volume equals a full-walk
    fusion of the same depths exactly, and its rendered depth agrees with
    the JAX backend's."""
    patch = np.zeros((H, W), np.float32)
    patch[20:40, 30:50] = 1.5
    kfs = [(_wall(), np.eye(4, dtype=np.float32)), (patch, _turn(80.0)),
           (_wall(), np.eye(4, dtype=np.float32))]
    img = np.zeros((H, W, 3), np.uint8)
    img[..., 1] = 90
    window = [img] * 7

    def poses(p):
        return [p] * 5 + [p, p]            # ref index V-2 carries p

    tb = TandemBackend(_DepthRunner([d for d, _ in kfs] + [_wall()],
                                    T_), tt.TsdfConfig(**KW), K, H, W)
    jb = JTandemBackend(_DepthRunner([d for d, _ in kfs] + [_wall()],
                                     jnp.asarray), jt.TsdfConfig(**KW), K,
                        H, W, mesh_extraction_freq=0)
    culled = []
    for i, (_, p) in enumerate(kfs + [kfs[0]]):
        nxt = kfs[min(i, len(kfs) - 1)][1]
        for b in (tb, jb):
            b.call(window, poses(p), 0.5, 6.0, nxt)
        if i == 0:
            continue
        culled.append(tb.last_fuse["culled_integrate"])
        dt = tb.get_tracking_depth_map()["depth"].numpy()
        dj = np.asarray(jb.get_tracking_depth_map()["depth"])
        assert (np.abs(dt - dj) <= 1e-3).mean() >= 0.99
        assert tb.stats()["n_allocated"] == jb.stats()["n_allocated"]
    assert culled == [False, True, False]

    vol = tt.create_volume(tt.TsdfConfig(**KW), "cpu")
    rgb = T_(np.ascontiguousarray(img[..., ::-1], dtype=np.float32))
    for d, p in kfs:
        tt.allocate_blocks(CFG, vol, T_(d), T_(K), T_(p))
        tt.integrate(CFG, vol, T_(d), rgb, T_(K), T_(p))
    assert vol.n_allocated == tb.volume.n_allocated
    _assert_same_volume(vol, tb.volume)
