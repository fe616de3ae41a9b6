"""TSDF fusion parity: the PyTorch port against the JAX package.

Scenes are small (60x80 depth, 2 cm voxels, a 64^3 page table) and stay
well under 16k new blocks per scan, the bound of the JAX package's
allocator. Block slots may differ in order, so blocks are compared by
their coordinates. Tolerances: tsdf and colour atol 1e-5 (the JAX package
reads depth and the per-pixel ray norm from f16 split-precision packs,
relative error ~2^-21); weights equal on >= 99.9% of voxels (that rounding
can move a voxel across the band edge); rendered depth within 1e-4 m on
>= 99.5% of pixels.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tandem_tpu.mapping import tsdf as jt
from tandem_tpu_torch.mapping import tsdf as tt

H, W = 60, 80
KW = dict(voxel_size=0.02, table_dim=64, pool_size=4096, truncation=0.08,
          max_depth=8.0)
K = np.array([[70.0, 0, (W - 1) / 2], [0, 70.0, (H - 1) / 2], [0, 0, 1]],
             np.float32)


def _pose(rx=0.0, ry=0.0, t=(0.0, 0.0, 0.0)):
    cx, sx, cy, sy = np.cos(rx), np.sin(rx), np.cos(ry), np.sin(ry)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = Ry @ Rx
    p[:3, 3] = t
    return p


def _scans():
    """Two seeded scans of a bumpy surface from two poses."""
    rng = np.random.RandomState(21)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    scans = []
    for i, pose in enumerate((_pose(), _pose(0.05, -0.08, (0.1, -0.05, 0.1)))):
        depth = (1.8 + 0.3 * np.sin(u * 0.11 + i) * np.cos(v * 0.07)
                 + 0.01 * rng.rand(H, W)).astype(np.float32)
        depth[:6, :10] = 0.0                       # a hole: invalid pixels
        color = rng.randint(0, 256, (H, W, 3)).astype(np.float32)
        scans.append((depth, color, pose))
    return scans


def _fuse_both(scans):
    cfg_j, cfg_t = jt.TsdfConfig(**KW), tt.TsdfConfig(**KW)
    vj, vt = jt.create_volume(cfg_j), tt.create_volume(cfg_t, "cpu")
    Kt = torch.from_numpy(K)
    for depth, color, pose in scans:
        vj = jt.allocate_blocks(cfg_j, vj, jnp.asarray(depth),
                                jnp.asarray(K), jnp.asarray(pose))
        vj = jt.integrate(cfg_j, vj, jnp.asarray(depth), jnp.asarray(color),
                          jnp.asarray(K), jnp.asarray(pose))
        d, c, p = (torch.from_numpy(x) for x in (depth, color, pose))
        tt.allocate_blocks(cfg_t, vt, d, Kt, p)
        tt.integrate(cfg_t, vt, d, c, Kt, p)
    return cfg_j, vj, cfg_t, vt


def _blocks(coords, n):
    return {tuple(c) for c in np.asarray(coords)[:n].tolist()}


@pytest.fixture(scope="module")
def fused():
    return _fuse_both(_scans())


def test_allocate_blocks_matches_jax():
    depth, _, pose = _scans()[1]
    cfg_j, cfg_t = jt.TsdfConfig(**KW), tt.TsdfConfig(**KW)
    vj = jt.allocate_blocks(cfg_j, jt.create_volume(cfg_j),
                            jnp.asarray(depth), jnp.asarray(K),
                            jnp.asarray(pose))
    vt = tt.allocate_blocks(cfg_t, tt.create_volume(cfg_t, "cpu"),
                            torch.from_numpy(depth), torch.from_numpy(K),
                            torch.from_numpy(pose))
    n = int(vj.n_allocated)
    assert 0 < n < cfg_j.pool_size
    assert vt.n_allocated == n
    assert _blocks(vt.block_coords, n) == _blocks(vj.block_coords, n)
    # The page table points every allocated block back at its slot.
    flat, ok = tt._table_index(cfg_t, vt.block_coords[:n])
    assert bool(ok.all())
    np.testing.assert_array_equal(vt.page_table[flat].numpy(), np.arange(n))
    assert int((vt.page_table >= 0).sum()) == n
    # Idempotent.
    tt.allocate_blocks(cfg_t, vt, torch.from_numpy(depth),
                       torch.from_numpy(K), torch.from_numpy(pose))
    assert vt.n_allocated == n and vt.n_dropped == 0


def test_integrate_matches_jax(fused):
    _, vj, _, vt = fused
    n = int(vj.n_allocated)
    assert vt.n_allocated == n
    slot_j = {tuple(c): i
              for i, c in enumerate(np.asarray(vj.block_coords)[:n].tolist())}
    order = np.array([slot_j[tuple(c)]
                      for c in vt.block_coords[:n].tolist()])
    wj = np.asarray(vj.weight)[order]
    wt = vt.weight[:n].numpy()
    assert wt.max() == 2.0 and (wt > 0).sum() > 1000
    same = wj == wt
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_allclose(vt.tsdf[:n].numpy()[same],
                               np.asarray(vj.tsdf)[order][same], atol=1e-5)
    np.testing.assert_allclose(vt.color[:n].numpy()[same],
                               np.asarray(vj.color)[order][same], atol=1e-5)


def test_render_depth_splat_matches_jax(fused):
    cfg_j, vj, cfg_t, vt = fused
    for pose in (_pose(), _pose(0.02, 0.05, (0.05, 0.0, -0.1))):
        rj = np.asarray(jt.render_depth_splat(cfg_j, vj, jnp.asarray(K),
                                              jnp.asarray(pose), H, W))
        rt = tt.render_depth_splat(cfg_t, vt, torch.from_numpy(K),
                                   torch.from_numpy(pose), H, W).numpy()
        assert (rt > 0).mean() > 0.5
        close = np.abs(rt - rj) <= 1e-4
        assert close.mean() >= 0.995, close.mean()


def _wall_volume():
    cfg = tt.TsdfConfig(**KW)
    Kt, pose = torch.from_numpy(K), torch.eye(4)
    depth = torch.full((H, W), 2.0)
    color = torch.full((H, W, 3), 100.0)
    vol = tt.allocate_blocks(cfg, tt.create_volume(cfg, "cpu"), depth, Kt,
                             pose)
    for _ in range(3):
        vol = tt.integrate(cfg, vol, depth, color, Kt, pose)
    return cfg, vol, Kt, pose


def test_render_depth_splat_wall():
    """The wall contract of tests/test_tsdf.py::test_render_depth_splat_wall
    on the port."""
    cfg, vol, Kt, pose = _wall_volume()
    rdepth = tt.render_depth_splat(cfg, vol, Kt, pose, H, W).numpy()
    crop = rdepth[8:-8, 8:-8]
    hit = crop > 0
    assert hit.mean() > 0.97
    assert np.median(np.abs(crop[hit] - 2.0)) < cfg.voxel_size * 1.5
    pose2 = torch.tensor([[1, 0, 0, 0.15], [0, 1, 0, 0.0], [0, 0, 1, -0.3],
                          [0, 0, 0, 1]], dtype=torch.float32)
    r2 = tt.render_depth_splat(cfg, vol, Kt, pose2, H, W).numpy()
    hit2 = r2[10:-10, 14:-14] > 0
    assert hit2.mean() > 0.9
    err2 = np.abs(r2[10:-10, 14:-14][hit2] - 2.3)
    assert np.median(err2) < cfg.voxel_size * 2


def test_integrate_wall_weights():
    """tests/test_tsdf.py::test_allocate_and_integrate_wall on the port."""
    cfg, vol, _, _ = _wall_volume()
    w = vol.weight.numpy()
    assert w.max() == 3.0
    upd = w > 0
    assert upd.sum() > 1000
    assert np.abs(vol.tsdf.numpy()[upd]).max() <= cfg.truncation + 1e-5


def test_pool_growth_reallocates_dropped_blocks():
    """A pool too small for the scan counts its drops; growing it and
    re-running the idempotent allocation gives the big-pool block set."""
    depth, _, pose = _scans()[0]
    d, Kt, p = (torch.from_numpy(x) for x in (depth, K, pose))
    big = tt.allocate_blocks(tt.TsdfConfig(**KW),
                             tt.create_volume(tt.TsdfConfig(**KW), "cpu"),
                             d, Kt, p)
    n = big.n_allocated
    small_kw = dict(KW, pool_size=256, pool_max=4096)
    cfg = tt.TsdfConfig(**small_kw)
    vol = tt.allocate_blocks(cfg, tt.create_volume(cfg, "cpu"), d, Kt, p)
    assert vol.n_allocated == 256 and vol.n_dropped == n - 256
    while vol.n_allocated < n:
        cfg, vol = tt.grow_volume(cfg, vol)
        vol = tt.allocate_blocks(cfg, vol, d, Kt, p)
    assert cfg.pool_size >= n and vol.tsdf.shape[0] == cfg.pool_size
    assert _blocks(vol.block_coords, n) == _blocks(big.block_coords, n)
