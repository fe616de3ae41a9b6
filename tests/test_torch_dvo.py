"""The port's dvo-core DenseTracker (tandem_tpu_torch/tracking/dvo.py) and
distance map against the JAX package, on the CPU.

Each of tests/test_dvo.py's seven cases runs on the port with its bars;
then both packages take the same seeded inputs at a moved pose:
- the pyramid levels are equal exactly;
- _warp_residuals' r, gradients, points and valid mask are equal on every
  pixel except where a projected coordinate lies within 1e-4 px of the
  image border test (u < W-1, v < H-1) or of a corner cell's edge, where
  one rounding may flip the pixel: at most 0.1% of the pixels, and none
  on these inputs;
- _system's A and b within 1e-4 of their largest |entry| (the sums run in
  another order);
- dense_match_level's T within 1e-5, lambda equal, n equal and the
  log-likelihood within 1e-5 relative (the accept decisions are the same).
``distance_map`` and ``select_spread`` equal the JAX package's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tandem_tpu.tracking import distance_map as jdm
from tandem_tpu.tracking import dvo as jd
from tandem_tpu_torch.tracking import distance_map as tdm
from tandem_tpu_torch.tracking import dvo as td
from tests.test_dvo import CX, CY, FX, FY, H, W, _pose, render_plane

PLANES = ("intensity", "depth", "idx", "idy", "zdx", "zdy")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _pyr(inten, depth, levels):
    return td.build_rgbd_pyramid(_t(inten), _t(depth), FX, FY, CX, CY,
                                 num_levels=levels)


def _T(out):
    return out["T"].numpy()


def test_pyramid_construction():
    inten = np.arange(16, dtype=np.float32).reshape(4, 4)
    depth = np.full((4, 4), 2.0, np.float32)
    depth[1, 1] = -1.0
    pyr = td.build_rgbd_pyramid(_t(inten), _t(depth), 100.0, 100.0, 2.0,
                                1.5, num_levels=2)
    np.testing.assert_allclose(pyr[1].intensity.numpy(),
                               [[2.5, 4.5], [10.5, 12.5]])
    np.testing.assert_allclose(pyr[1].depth.numpy(), [[2.0, 2.0],
                                                      [2.0, 2.0]])
    assert pyr[1].K == (50.0, 50.0, 1.0, 0.75)
    np.testing.assert_allclose(pyr[0].idx.numpy()[0], [0.5, 1.0, 1.0, 0.5])
    np.testing.assert_allclose(pyr[0].idy.numpy()[:, 0], [2.0, 4.0, 4.0, 2.0])


def test_identity_residual_zero():
    inten, depth = render_plane(np.eye(4))
    pyr = _pyr(inten, depth, 2)
    out = td.dense_match_level(pyr[1], pyr[1], torch.eye(4), 0.01,
                               (1.0, 0.0), td.DvoConfig(max_iterations=3))
    np.testing.assert_allclose(_T(out), np.eye(4), atol=1e-4)
    assert float(out["n"]) > 0.9 * (H // 2) * (W // 2)


@pytest.mark.parametrize("motion", [
    dict(tx=0.03), dict(tz=0.04), dict(wy=0.01), dict(tx=0.02, wy=0.008)])
def test_recovers_pose(motion):
    c2w_cur = _pose(**motion)
    ref = _pyr(*render_plane(np.eye(4)), 2)
    cur = _pyr(*render_plane(c2w_cur), 2)
    T_gt = np.linalg.inv(c2w_cur)
    out = td.dense_match(ref, cur, torch.eye(4),
                         td.DvoConfig(max_iterations=12), on_level=1)
    T = _T(out)
    assert np.linalg.norm(T[:3, 3] - T_gt[:3, 3]) < 5e-3
    assert np.linalg.norm(T[:3, :3] - T_gt[:3, :3]) < 5e-3


def _noisy_blob():
    rng = np.random.RandomState(7)
    c2w_cur = _pose(tx=0.025)
    ref_i, ref_d = render_plane(np.eye(4))
    cur_i, cur_d = render_plane(c2w_cur)
    for d in (ref_d, cur_d):
        d += rng.normal(0, 0.003, d.shape).astype(np.float32)
    for i in (ref_i, cur_i):
        i += rng.normal(0, 1.0, i.shape).astype(np.float32)
    cur_i[20:60, 30:80] = 255.0
    return c2w_cur, (ref_i, ref_d), (cur_i, cur_d)


def test_tdist_downweights_outliers():
    """A corrupted intensity blob does not destroy the estimate: the
    bivariate t weights absorb it (test_dvo's bars)."""
    c2w_cur, ref, cur = _noisy_blob()
    T_gt = np.linalg.inv(c2w_cur)
    T_init = np.linalg.inv(_pose(tx=0.015)).astype(np.float32)
    out = td.dense_match(_pyr(*ref, 2), _pyr(*cur, 2), _t(T_init),
                         td.DvoConfig(max_iterations=12), on_level=1)
    T = _T(out)
    assert np.linalg.norm(T[:3, 3] - T_gt[:3, 3]) < 8e-3
    assert abs(T[0, 3] - T_gt[0, 3]) < 2e-3


def _occlusion_case():
    ref_i, ref_d = render_plane(np.eye(4))
    cur_d = ref_d.copy()
    ref_d2 = ref_d.copy()
    ref_d2[:30] = np.nan
    cur_d[60:90] = 0.2
    return (ref_i, ref_d2), (ref_i.copy(), cur_d)


def test_occlusion_gate_and_invalid_depth():
    ref, cur = _occlusion_case()
    out = td.dense_match_level(_pyr(*ref, 1)[0], _pyr(*cur, 1)[0],
                               torch.eye(4), 0.01, (1.0, 0.0),
                               td.DvoConfig(max_iterations=1))
    n = float(out["n"])
    assert 0.3 * H * W < n < 0.55 * H * W


def test_affine_light_model():
    c2w_cur = _pose(tx=0.02)
    ref_i, ref_d = render_plane(np.eye(4))
    cur_i, cur_d = render_plane(c2w_cur)
    a, b = 1.2, -10.0
    T_gt = np.linalg.inv(c2w_cur)
    out = td.dense_match(_pyr(ref_i, ref_d, 2),
                         _pyr((cur_i * a + b).astype(np.float32), cur_d, 2),
                         torch.eye(4), td.DvoConfig(max_iterations=12),
                         on_level=1, affine_a=a, affine_b=b)
    assert np.linalg.norm(_T(out)[:3, 3] - T_gt[:3, 3]) < 5e-3


def test_reference_api_inverse():
    pyr = _pyr(*render_plane(np.eye(4)), 1)
    T0 = np.asarray(_pose(tx=0.01), np.float32)
    out = td.dense_match_level(pyr[0], pyr[0], _t(T0), 0.01, (1.0, 0.0),
                               td.DvoConfig(max_iterations=2))
    np.testing.assert_allclose(out["T_api"].numpy() @ _T(out), np.eye(4),
                               atol=1e-5)


# ---------------------------------------------------------------- parity
def _both_pyramids(levels=2):
    """The noisy blob scene: ref and cur pyramids in both packages."""
    _, ref, cur = _noisy_blob()
    jp = [jd.build_rgbd_pyramid(*x, FX, FY, CX, CY, num_levels=levels)
          for x in (ref, cur)]
    tp = [_pyr(*x, levels) for x in (ref, cur)]
    return jp, tp


def test_pyramid_matches_jax():
    (jr, jc), (tr, tc) = _both_pyramids(levels=3)
    for jl, tl in zip(jr + jc, tr + tc):
        assert jl.K == tl.K
        for name in PLANES:
            np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                          np.asarray(getattr(jl, name)))


def _moved():
    return np.linalg.inv(_pose(tx=0.017, wy=0.004)).astype(np.float32)


def _residuals_both():
    (jr, jc), (tr, tc) = _both_pyramids()
    T = _moved()
    ref_valid = np.isfinite(np.asarray(jr[1].depth))
    ja = jd._warp_residuals(jr[1], jc[1], jnp.asarray(T), 1.1, -3.0,
                            jnp.asarray(ref_valid))
    ta = td._warp_residuals(tr[1], tc[1], _t(T), torch.tensor(1.1),
                            torch.tensor(-3.0), torch.from_numpy(ref_valid))
    return [np.asarray(x) for x in ja], [x.numpy() for x in ta]


def test_warp_residuals_match_jax():
    (r, gi, gz, p, valid), (r_t, gi_t, gz_t, p_t, valid_t) = \
        _residuals_both()
    flips = valid != valid_t
    assert flips.mean() <= 1e-3, flips.sum()
    same = ~flips
    for a, b in ((r, r_t), (gi, gi_t), (gz, gz_t), (p, p_t)):
        np.testing.assert_array_equal(b[same], a[same])
    assert valid.sum() > 0.5 * valid.size


def test_system_matches_jax():
    (r, gi, gz, p, valid), _ = _residuals_both()
    rng = np.random.RandomState(3)
    w = rng.rand(r.shape[0]).astype(np.float32) + 0.5
    prec = np.array([[2.0e4, 30.0], [30.0, 4.0e4]], np.float32)
    Aj, bj = jd._system(*(jnp.asarray(x) for x in (r, gi, gz, p, valid, w,
                                                    prec)))
    At, bt = td._system(*(torch.from_numpy(np.array(x)) for x in (
        r, gi, gz, p, valid, w, prec)))
    Aj, bj = np.asarray(Aj), np.asarray(bj)
    assert np.abs(At.numpy() - Aj).max() <= 1e-4 * np.abs(Aj).max()
    assert np.abs(bt.numpy() - bj).max() <= 1e-4 * np.abs(bj).max()
    Pj, nj = jd._tdist_precision(jnp.asarray(r), jnp.asarray(valid),
                                 jnp.asarray(w))
    Pt, nt = td._tdist_precision(*(torch.from_numpy(np.array(x))
                                   for x in (r, valid, w)))
    assert float(nt) == float(nj)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-5)


@pytest.mark.parametrize("case", ["blob", "occlusion"])
def test_dense_match_level_matches_jax(case):
    if case == "blob":
        (jr, jc), (tr, tc) = _both_pyramids()
        lvl, T0, cfg = 1, _moved(), jd.DvoConfig(max_iterations=8)
    else:
        ref, cur = _occlusion_case()
        jr, jc = (jd.build_rgbd_pyramid(*x, FX, FY, CX, CY, num_levels=1)
                  for x in (ref, cur))
        tr, tc = (_pyr(*x, 1) for x in (ref, cur))
        lvl, T0, cfg = 0, np.eye(4, dtype=np.float32), jd.DvoConfig(
            max_iterations=1)
    oj = jd.dense_match_level(jr[lvl], jc[lvl], jnp.asarray(T0), 0.01,
                              jnp.array([1.0, 0.0]), cfg)
    ot = td.dense_match_level(tr[lvl], tc[lvl], _t(T0), 0.01, (1.0, 0.0),
                              td.DvoConfig(*cfg))
    np.testing.assert_allclose(_T(ot), np.asarray(oj["T"]), atol=1e-5)
    assert float(ot["lambda"]) == float(oj["lambda"])
    assert float(ot["n"]) == float(oj["n"])
    llj, llt = float(oj["log_likelihood"]), float(ot["log_likelihood"])
    if np.isfinite(llj):
        assert abs(llt - llj) <= 1e-5 * abs(llj)
    else:
        assert llt == llj


def test_dense_match_schedule_matches_jax():
    """Coarse to fine (levels 2..1 of a 3-level pyramid), lambda threaded
    across levels."""
    (jr, jc), (tr, tc) = _both_pyramids(levels=3)
    cfg = jd.DvoConfig(first_level=2, last_level=1, max_iterations=6)
    oj = jd.dense_match(jr, jc, jnp.asarray(_moved()), cfg)
    ot = td.dense_match(tr, tc, _t(_moved()), td.DvoConfig(*cfg))
    np.testing.assert_allclose(_T(ot), np.asarray(oj["T"]), atol=1e-5)
    assert float(ot["lambda"]) == float(oj["lambda"])
    assert float(ot["n"]) == float(oj["n"])


# ---------------------------------------------------------- distance map
def test_distance_map_matches_jax():
    occ = np.zeros((16, 16), bool)
    occ[4, 4] = True
    occ[12, 12] = True
    d = tdm.distance_map(torch.from_numpy(occ), max_dist=30).numpy()
    assert d[4, 4] == 0 and d[4, 7] == 3 and d[8, 8] == 8
    np.testing.assert_array_equal(
        d, np.asarray(jdm.distance_map(jnp.asarray(occ), 30)))
    rng = np.random.RandomState(5)
    occ2 = rng.rand(37, 53) < 0.01
    for md in (5, 40):
        np.testing.assert_array_equal(
            tdm.distance_map(torch.from_numpy(occ2), md).numpy(),
            np.asarray(jdm.distance_map(jnp.asarray(occ2), md)))


def test_select_spread_matches_jax():
    occ = np.zeros((16, 16), bool)
    occ[4, 4] = True
    occ[12, 12] = True
    cand = np.zeros((16, 16), bool)
    cand[0, 0] = True
    cand[5, 4] = True
    sel = tdm.select_spread(cand, occ, want=1)
    assert tuple(sel[0]) == (0, 0)
    rng = np.random.RandomState(6)
    occ2, cand2 = rng.rand(40, 60) < 0.02, rng.rand(40, 60) < 0.1
    for want in (1, 17, 1000):
        np.testing.assert_array_equal(
            tdm.select_spread(cand2, occ2, want),
            jdm.select_spread(cand2, occ2, want))
    assert tdm.select_spread(np.zeros((4, 4), bool), occ2[:4, :4],
                             3).shape == (0, 2)
