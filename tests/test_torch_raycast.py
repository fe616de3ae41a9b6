"""The port's TSDF raycast (K9), ``_get_interpolated``, ``copy_volume`` and
``render_depth_splat(fill_rounds=)`` against the JAX package, on the CPU.

The scenes are tests/test_tsdf.py's wall, sphere and concave corner (60x80,
2 cm voxels), with a smooth colour field. Two comparisons:

- the march alone: given the JAX package's z-buffer and its volume with
  the sdf and colour rounded to bf16 (the tables the JAX march reads), the
  port's ``_raycast_march`` gives the JAX package's depth exactly and its
  colour within 1e-4;
- the whole raycast, the port on its float32 volume: the JAX package reads
  bf16 tables (a TPU gather trick; the reference reads f32), whose sdf is
  within 2^-9 relative, <= 1.6e-4 m in the 0.08 m band, and its seed
  z-buffer comes from f16 split packs. The march reads voxels without
  interpolation, so a ray whose position rounds across a voxel face reads
  the next voxel, or an empty one, and may then step a whole truncation
  differently. Hence: >= 99% of the hit masks agree; over the pixels where
  both hit, depth within 1e-3 m on >= 90% and within 0.08 m (one
  truncation step) on all; colour within 2.0 on >= 90% (bf16's half-ulp
  at 128-255 is 0.5, plus the trilinear weights of a moved hit point).

The three analytic bars of tests/test_tsdf.py also hold on the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tandem_tpu.mapping import tsdf as jt
from tandem_tpu_torch.mapping import tsdf as tt

H, W = 60, 80
KW = dict(voxel_size=0.02, table_dim=64, pool_size=4096, truncation=0.08,
          max_depth=8.0)
K = np.array([[70.0, 0, (W - 1) / 2], [0, 70.0, (H - 1) / 2], [0, 0, 1]],
             np.float32)
VS = KW["voxel_size"]


def _rays():
    u = np.tile(np.arange(W, dtype=np.float32), (H, 1))
    v = np.tile(np.arange(H, dtype=np.float32)[:, None], (1, W))
    return (u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1]


def _sphere_depth():
    dx, dy = _rays()
    a = dx ** 2 + dy ** 2 + 1
    b = -2 * 2.0
    cc = 4.0 - 0.25
    disc = b ** 2 - 4 * a * cc
    tmin = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a),
                    0)
    return np.where(disc > 0, tmin, 0).astype(np.float32)


def _corner_depth(cam_t):
    dx, _ = _rays()
    t_front = 2.2 - cam_t[2]
    t_side = np.where(dx > 1e-6, (0.75 - cam_t[0]) / np.where(
        dx > 1e-6, dx, 1.0), np.inf)
    hit_side = (t_side > 0) & (t_side < t_front)
    z = np.where(hit_side, t_side, t_front)
    x = cam_t[0] + dx * z
    return np.where(x <= 0.75 + 1e-6, z, 0).astype(np.float32)


def _pose(t=(0.0, 0.0, 0.0)):
    p = np.eye(4, dtype=np.float32)
    p[:3, 3] = t
    return p


CORNER_T2 = np.array([0.25, 0.05, 0.6], np.float32)
SCENES = {
    # name: (depth, integrations, render pose)
    "wall": (np.full((H, W), 2.0, np.float32), 3, _pose()),
    "sphere": (_sphere_depth(), 1, _pose()),
    "corner": (_corner_depth(np.zeros(3)), 3, _pose(CORNER_T2)),
}


def _color():
    """A smooth colour field (a per-pixel random one makes neighbouring
    voxels' colours unrelated, so any moved hit point changes its colour
    by ~100)."""
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    return np.stack([128 + 100 * np.sin(u * 0.07),
                     128 + 100 * np.cos(v * 0.09),
                     60 + 0.5 * u + v], -1).astype(np.float32)


def _fuse(pkg, name):
    depth, reps, _ = SCENES[name]
    color, pose = _color(), _pose()
    if pkg is jt:
        cfg = jt.TsdfConfig(**KW)
        vol = jt.create_volume(cfg)
        args = (jnp.asarray(depth), jnp.asarray(K), jnp.asarray(pose))
        vol = jt.allocate_blocks(cfg, vol, *args)
        for _ in range(reps):
            vol = jt.integrate(cfg, vol, args[0], jnp.asarray(color),
                               *args[1:])
        return cfg, vol
    cfg = tt.TsdfConfig(**KW)
    vol = tt.create_volume(cfg, "cpu")
    d, c, k, p = (torch.from_numpy(x) for x in (depth, color, K, pose))
    tt.allocate_blocks(cfg, vol, d, k, p)
    for _ in range(reps):
        tt.integrate(cfg, vol, d, c, k, p)
    return cfg, vol


@pytest.fixture(scope="module")
def volumes():
    return {name: (_fuse(jt, name), _fuse(tt, name)) for name in SCENES}


def _raycast_port(volumes, name, pose=None):
    cfg, vol = volumes[name][1]
    p = SCENES[name][2] if pose is None else pose
    d, c = tt.raycast(cfg, vol, (torch.from_numpy(K), torch.from_numpy(p)),
                      H, W)
    return d.numpy(), c.numpy()


def _jax_zbuf(cfg, vol, K_, pose, chunk=2048):
    """The JAX raycast's seed: the full-walk splat z-buffer."""
    w2c_R, w2c_t, zbuf = jt._splat_init(pose, H, W)
    n = int(vol.n_allocated)
    pair = jt._pair_table(vol, n, chunk)
    for start in range(0, n, chunk):
        zbuf = jt._splat_chunk(cfg, zbuf, vol, pair, K_, w2c_R, w2c_t, start,
                               chunk, H, W)
    return zbuf


@pytest.mark.parametrize("name", list(SCENES))
def test_raycast_march_matches_jax(volumes, name):
    (cfg_j, vol_j), (cfg_t, _) = volumes[name]
    Kj, pose = jnp.asarray(K), jnp.asarray(SCENES[name][2])
    zbuf = _jax_zbuf(cfg_j, vol_j, Kj, pose)
    n_pool = min(-(-int(vol_j.n_allocated) // 2048) * 2048, cfg_j.pool_size)
    dj, cj = (np.asarray(x) for x in jt._raycast_march(
        cfg_j, vol_j, Kj, pose, zbuf, H, W, n_pool=n_pool))

    def t(name_, bf16=False):
        x = torch.from_numpy(np.array(getattr(vol_j, name_)))
        return x.to(torch.bfloat16).float() if bf16 else x
    vol_bf16 = tt.TsdfVolume(page_table=t("page_table"),
                             block_coords=t("block_coords"),
                             tsdf=t("tsdf", True), weight=t("weight"),
                             color=t("color", True),
                             n_allocated=int(vol_j.n_allocated))
    dt, ct = tt._raycast_march(cfg_t, vol_bf16, torch.from_numpy(K),
                               torch.from_numpy(SCENES[name][2]),
                               torch.from_numpy(np.array(zbuf)), H, W)
    assert (dj > 0).sum() > 500
    np.testing.assert_array_equal(dt.numpy(), dj)
    # The colour's eight-term trilinear sums round differently in XLA's
    # fused loop: up to 4 ulps at 128-255 (6.1e-5) on these scenes.
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", list(SCENES))
def test_raycast_matches_jax(volumes, name):
    (cfg_j, vol_j), _ = volumes[name]
    dj, cj = (np.asarray(x) for x in jt.raycast(
        cfg_j, vol_j, (jnp.asarray(K), jnp.asarray(SCENES[name][2])), H, W))
    dt, ct = _raycast_port(volumes, name)
    hj, ht = dj > 0, dt > 0
    assert (hj == ht).mean() >= 0.99, (hj != ht).sum()
    both = hj & ht
    assert both.sum() > 500
    err = np.abs(dj - dt)[both]
    assert (err <= 1e-3).mean() >= 0.90, (err <= 1e-3).mean()
    assert err.max() <= 0.08, err.max()
    cerr = np.abs(cj - ct).max(-1)[both]
    assert (cerr <= 2.0).mean() >= 0.90, (cerr <= 2.0).mean()
    assert not ct[~ht].any()


def test_raycast_roundtrip_wall(volumes):
    rdepth, rcolor = _raycast_port(volumes, "wall")
    crop = rdepth[10:-10, 10:-10]
    hit = crop > 0
    assert hit.mean() > 0.98
    err = np.abs(crop[hit] - 2.0)
    assert np.median(err) < VS * 1.5, np.median(err)
    assert np.mean(err) < VS * 3
    # colour is rendered: each channel's mean within 30 of the input's
    rc = rcolor[10:-10, 10:-10]
    assert np.abs(rc[hit].mean(0) - _color()[10:-10, 10:-10][hit].mean(0)
                  ).max() < 30


def test_raycast_sphere(volumes):
    rdepth, _ = _raycast_port(volumes, "sphere")
    gt = SCENES["sphere"][0]
    both = (rdepth > 0) & (gt > 0)
    assert both.sum() > 100
    assert np.median(np.abs(rdepth[both] - gt[both])) < VS * 2


def test_raycast_roundtrip_concave_corner(volumes):
    rdepth, _ = _raycast_port(volumes, "corner")
    gt2 = _corner_depth(CORNER_T2)
    crop = np.s_[8:-8, 8:-8]
    r, g = rdepth[crop], gt2[crop]
    both = (r > 0) & (g > 0)
    assert both.mean() > 0.7
    assert np.median(np.abs(r[both] - g[both])) < VS * 1.5
    side = both & (np.abs(g - 2.2 + CORNER_T2[2]) > 0.1)
    assert side.sum() > 50
    assert np.median(np.abs(r[side] - g[side])) < VS * 2.5


def test_get_interpolated_matches_jax(volumes):
    """Points in the band, in free space, outside the arena and on voxel
    faces: weights equal, sdf and colour within 1e-5 (the JAX volume's sdf
    differs from the port's by its f16 packs' rounding, so the port is
    given the JAX volume's tensors)."""
    (cfg_j, vol_j), (cfg_t, vol_t) = volumes["corner"]
    rng = np.random.RandomState(8)
    pts = np.concatenate([
        rng.uniform([-0.6, -0.5, 1.9], [0.8, 0.5, 2.4], (4000, 3)),
        rng.uniform(-0.8, 0.8, (500, 3)),
        np.round(rng.uniform(-0.5, 0.5, (300, 3)) / VS) * VS
        + [0.0, 0.0, 2.2],
        [[50.0, 0.0, 2.0], [0.0, -50.0, 2.0]]]).astype(np.float32)
    vol_from_j = tt.TsdfVolume(**{
        f: torch.from_numpy(np.array(getattr(vol_j, f)))
        for f in ("page_table", "block_coords", "tsdf", "weight", "color")},
        n_allocated=int(vol_j.n_allocated))
    # Compiled, as the JAX package runs its voxel lookups (a division by a
    # constant becomes a product with its reciprocal).
    interp = jax.jit(jt._get_interpolated, static_argnums=0)
    sj, wj, cj = (np.asarray(x) for x in interp(cfg_j, vol_j,
                                                 jnp.asarray(pts)))
    st, wt, ct = (x.numpy() for x in tt._get_interpolated(
        cfg_t, vol_from_j, torch.from_numpy(pts)))
    np.testing.assert_array_equal(wt, wj)
    assert (wj > 0).sum() > 1000
    np.testing.assert_allclose(st, sj, atol=1e-5)
    np.testing.assert_allclose(ct, cj, atol=1e-5 * 255)


@pytest.mark.parametrize("rounds", [2, 4])
def test_fill_rounds_match_jax(volumes, rounds):
    """render_depth_splat(fill_rounds=) and _fill_holes(depth, rounds)
    equal the JAX package's on a sparse depth map and on the wall's splat
    (the splat itself within test_torch_tsdf.py's 1e-4 m)."""
    rng = np.random.RandomState(9)
    sparse = np.where(rng.rand(H, W) < 0.15,
                      rng.uniform(0.5, 4.0, (H, W)), 0).astype(np.float32)
    np.testing.assert_array_equal(
        tt._fill_holes(torch.from_numpy(sparse), rounds).numpy(),
        np.asarray(jt._fill_holes(jnp.asarray(sparse), rounds)))
    (cfg_j, vol_j), (cfg_t, vol_t) = volumes["sphere"]
    rj = np.asarray(jt.render_depth_splat(
        cfg_j, vol_j, jnp.asarray(K), jnp.asarray(_pose()), H, W,
        fill_rounds=rounds))
    rt = tt.render_depth_splat(cfg_t, vol_t, torch.from_numpy(K),
                               torch.from_numpy(_pose()), H, W,
                               fill_rounds=rounds).numpy()
    np.testing.assert_array_equal(rt > 0, rj > 0)
    assert (np.abs(rt - rj) <= 1e-4).mean() >= 0.995
    if rounds == 2:
        default = tt.render_depth_splat(cfg_t, vol_t, torch.from_numpy(K),
                                        torch.from_numpy(_pose()), H, W)
        assert torch.equal(default, torch.from_numpy(rt))


def test_copy_volume_is_independent(volumes):
    cfg, vol = _fuse(tt, "wall")
    copy = tt.copy_volume(vol)
    fields = ("page_table", "block_coords", "tsdf", "weight", "color")
    before = {f: getattr(vol, f).clone() for f in fields}
    depth = torch.full((H, W), 1.5)
    tt.allocate_blocks(cfg, copy, depth, torch.from_numpy(K),
                       torch.from_numpy(_pose()))
    tt.integrate(cfg, copy, depth, torch.full((H, W, 3), 9.0),
                 torch.from_numpy(K), torch.from_numpy(_pose()))
    assert copy.n_allocated > vol.n_allocated
    for f in fields:
        assert torch.equal(getattr(vol, f), before[f]), f
        assert getattr(copy, f).data_ptr() != getattr(vol, f).data_ptr()
    assert not torch.equal(copy.tsdf, vol.tsdf)
