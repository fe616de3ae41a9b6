"""The dense coarse tracker: the PyTorch port against the JAX package.

Seeded numpy inputs go to both packages; the port runs on the CPU, where
kernel K6 (``ops/track_reduce.py``) is its plain version. Tolerances, with
their reasons:
- se3 and the pyramid: 1e-6 absolute (the same f32 formulas; matrix
  products may sum in another order);
- Gauss-Jordan: 1e-5 relative (unpivoted elimination of a damped SPD
  system, the same sequence of row operations);
- splat_depth_to_ref: weights exact, inverse depths 1e-6 relative;
- make_tracker_ref: pu, pv, pvalid exact, pid and pcolor 1e-5 relative;
- _energy_and_system: 1e-4 relative to the largest |entry| (sums of up to
  ~10^4 terms in another order; the JAX package samples a corner-packed
  table), num exact;
- whole tracks: 1e-4 in translation (m) and in rotation entries (LM accept
  decisions can flip on near-ties in another summation order).
The slice test tracks against a TSDF model fused from the GT depths of
``tests/fixtures/replica_traj``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tandem_tpu.core import pyramid as jpyr
from tandem_tpu.core import se3 as jse3
from tandem_tpu.mapping import tsdf as jtsdf
from tandem_tpu.ops import linalg as jlin
from tandem_tpu.tracking import coarse_tracker as jct
from tandem_tpu_torch.core import pyramid as tpyr
from tandem_tpu_torch.core import se3 as tse3
from tandem_tpu_torch.data.replica import ReplicaScene
from tandem_tpu_torch.mapping import tsdf as ttsdf
from tandem_tpu_torch.ops import linalg as tlin
from tandem_tpu_torch.ops.track_reduce import track_reduce
from tandem_tpu_torch.tracking import coarse_tracker as tct
from tests.test_coarse_tracker import CX, CY, FX, FY, H, W, render_plane
from torch_cases import MVS_TRACK_BOUND

T_ = torch.from_numpy
FIXTURE = "tests/fixtures/replica_traj/scene0"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# --- se3, pyramid, linalg ----------------------------------------------------

def _xis():
    rng = np.random.RandomState(0)
    xi = rng.uniform(-0.8, 0.8, (16, 6)).astype(np.float32)
    xi[:4, 3:] *= 1e-4            # Taylor branches (theta^2 < 1e-5)
    xi[4, 3:] = 0.0
    return xi


def test_se3_matches_jax():
    xi = _xis()
    pairs = [
        (jse3.se3_exp(jnp.asarray(xi)), tse3.se3_exp(T_(xi))),
        (jse3.so3_exp(jnp.asarray(xi[:, 3:])), tse3.so3_exp(T_(xi[:, 3:]))),
        (jse3._hat(jnp.asarray(xi[:, :3])), tse3._hat(T_(xi[:, :3]))),
    ]
    Tm = np.array(jse3.se3_exp(jnp.asarray(xi)))
    pairs += [
        (jse3.se3_log(jnp.asarray(Tm)), tse3.se3_log(T_(Tm))),
        (jse3.so3_log(jnp.asarray(Tm[:, :3, :3])),
         tse3.so3_log(T_(Tm[:, :3, :3]))),
        (jse3.se3_inverse(jnp.asarray(Tm)), tse3.se3_inverse(T_(Tm))),
        (jse3.se3_compose(jnp.asarray(Tm), jnp.asarray(Tm[::-1])),
         tse3.se3_compose(T_(Tm), T_(Tm[::-1].copy()))),
        (jse3.se3_identity(), tse3.se3_identity()),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(_np(t), np.asarray(j), atol=1e-6, rtol=0)


def test_pyramid_matches_jax():
    img = np.random.RandomState(1).uniform(0, 255, (97, 131)).astype(
        np.float32)
    pj = jpyr.build_pyramid(jnp.asarray(img), 6)
    pt = tpyr.build_pyramid(T_(img), 6)
    for lj, lt in zip(pj, pt):
        for k in ("img", "gx", "gy", "abs_grad2"):
            assert lt[k].shape == lj[k].shape
            np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]),
                                       atol=1e-6 * 255 ** 2 if k ==
                                       "abs_grad2" else 1e-6 * 255)
    assert (tpyr.pyramid_intrinsics(FX, FY, CX, CY, 6)
            == jpyr.pyramid_intrinsics(FX, FY, CX, CY, 6))


def _spd(B=5, n=8, seed=2):
    rng = np.random.RandomState(seed)
    J = rng.randn(B, 40, n).astype(np.float32)
    A = np.einsum("bki,bkj->bij", J, J) + 1e-2 * np.eye(n, dtype=np.float32)
    return A.astype(np.float32), rng.randn(B, n).astype(np.float32)


def test_linalg_matches_jax():
    A, b = _spd()
    x_j = jlin.solve_gauss_jordan_batched(jnp.asarray(A), jnp.asarray(b), 8)
    x_t = tlin.solve_gauss_jordan_batched(T_(A), T_(b), 8)
    assert _rel(x_t, x_j) <= 1e-5
    assert _rel(tlin.solve_gauss_jordan(T_(A[0]), T_(b[0]), 8),
                jlin.solve_gauss_jordan(jnp.asarray(A[0]),
                                        jnp.asarray(b[0]), 8)) <= 1e-5
    assert _rel(tlin.cholesky_small(T_(A[1]), 8),
                jlin.cholesky_small(jnp.asarray(A[1]), 8)) <= 1e-5
    assert _rel(tlin.solve_psd(T_(A[2]), T_(b[2])),
                jlin.solve_psd(jnp.asarray(A[2]), jnp.asarray(b[2]))) <= 1e-5
    assert _rel(tlin.inv_psd_small(T_(A[3]), 8),
                jlin.inv_psd_small(jnp.asarray(A[3]), 8)) <= 1e-5


# --- reference building ------------------------------------------------------

KMAT = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)


def _render_c2w():
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.05, -0.02, 0.03]
    return c2w


def _dense_maps():
    """The plane rendered from an offset camera, splatted into the identity
    reference with both packages (the dense injection inputs)."""
    rc2w = _render_c2w()
    _, rdepth = render_plane(rc2w.astype(np.float64))
    rdepth[:5, :7] = 0.0                        # holes
    args = (rdepth, rc2w, np.eye(4, dtype=np.float32), KMAT)
    t = tct.splat_depth_to_ref(*(T_(a) for a in args), H, W)
    j = jct.splat_depth_to_ref(*(jnp.asarray(a) for a in args), H, W)
    return t, j


def test_splat_depth_to_ref_matches_jax():
    (id_t, w_t), (id_j, w_j) = _dense_maps()
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    assert w_t.sum() > 500
    assert _rel(id_t, id_j) <= 1e-6


def _ref_inputs(kind: str):
    ref_img, ref_depth = render_plane(np.eye(4))
    if kind == "dense":
        (id_t, w_t), _ = _dense_maps()
        mask = np.zeros((H, W), np.float32)
        mask[::8, ::8] = 1.0
        return ref_img, dict(sparse_idepth=(1.0 / ref_depth) * mask,
                             sparse_weight=mask, dense_idepth=id_t.numpy(),
                             dense_weight=w_t.numpy())
    # sparse, full weight: every level is over capacity (even decimation)
    return ref_img, dict(sparse_idepth=1.0 / ref_depth,
                         sparse_weight=np.ones((H, W), np.float32))


def _make_refs(kind: str):
    ref_img, maps = _ref_inputs(kind)
    rj = jct.make_tracker_ref(jnp.asarray(ref_img), FX, FY, CX, CY,
                              **{k: jnp.asarray(v) for k, v in maps.items()})
    rt = tct.make_tracker_ref(T_(ref_img), FX, FY, CX, CY,
                              **{k: T_(v) for k, v in maps.items()})
    return rj, rt


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_make_tracker_ref_matches_jax(kind):
    rj, rt = _make_refs(kind)
    assert rt.K == tuple(tuple(k) for k in rj.K)
    for lvl in range(tct.NUM_LEVELS):
        for f in ("pu", "pv", "pvalid"):
            np.testing.assert_array_equal(getattr(rt, f)[lvl].numpy(),
                                          np.asarray(getattr(rj, f)[lvl]))
        for f in ("pid", "pcolor"):
            assert _rel(getattr(rt, f)[lvl], getattr(rj, f)[lvl]) <= 1e-5
    assert int(rt.pvalid[0].sum()) > 500
    if kind == "sparse":   # decimated: the level-0 list is full
        assert bool(rt.pvalid[0].all())


# --- residuals and normal equations -----------------------------------------

def _candidates(B=5, seed=4):
    rng = np.random.RandomState(seed)
    xi = rng.uniform(-0.03, 0.03, (B, 6)).astype(np.float32)
    Ts = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    aff = np.stack([1.0 + rng.uniform(-0.1, 0.1, B),
                    rng.uniform(-5, 5, B)], -1).astype(np.float32)
    return Ts, aff


@pytest.mark.parametrize("tdist", [False, True])
def test_energy_and_system_matches_jax(tdist):
    rj, rt = _make_refs("dense")
    xi = np.array([0.03, -0.01, 0.02, 0.01, 0.005, -0.008], np.float32)
    new_img, _ = render_plane(np.asarray(jse3.se3_exp(jnp.asarray(xi)),
                                         np.float64))
    Ts, aff = _candidates()
    pj = jpyr.build_pyramid(jnp.asarray(new_img), 6)
    pt = tpyr.build_pyramid(T_(new_img), 6)
    for lvl in (0, 2):
        packed = jct._pack_level(pj[lvl]["img"], pj[lvl]["gx"],
                                 pj[lvl]["gy"])
        h, w = pj[lvl]["img"].shape
        pts_j = tuple(getattr(rj, f)[lvl]
                      for f in ("pu", "pv", "pid", "pcolor", "pvalid"))
        out_j = jct._energy_and_system(jnp.asarray(Ts), jnp.asarray(aff),
                                       pts_j, packed, h, w, rj.K[lvl],
                                       tdist=tdist)
        out_t = tct._energy_and_system(T_(Ts), T_(aff), rt.level(lvl),
                                       tct._planes(pt[lvl]), rt.K[lvl],
                                       tdist=tdist)
        e_j, n_j, H_j, g_j = (np.asarray(x) for x in out_j)
        e_t, n_t, H_t, g_t = (x.numpy() for x in out_t)
        np.testing.assert_array_equal(n_t, n_j)
        assert n_t.min() > 50
        for a, b in ((e_t, e_j), (H_t, H_j), (g_t, g_j)):
            assert _rel(a, b) <= 1e-4, (lvl, _rel(a, b))


def test_track_reduce_plain_f64_agrees():
    """The f32 plain K6 against its own float64 evaluation, including an
    all-invalid list and an all-cutoff aff (every residual saturated)."""
    _, rt = _make_refs("dense")
    new_img, _ = render_plane(np.eye(4))
    pt = tpyr.build_pyramid(T_(new_img), 6)
    Ts, aff = _candidates(3)
    planes = tct._planes(pt[0])
    pts = rt.level(0)
    out32 = track_reduce(T_(Ts), T_(aff), pts, planes, rt.K[0])
    out64 = track_reduce(T_(Ts).double(), T_(aff).double(),
                         tuple(p.double() if p.is_floating_point() else p
                               for p in pts),
                         tuple(p.double() for p in planes), rt.K[0])
    for a, b in zip(out32, out64):
        assert _rel(a, b) <= 1e-5
    none = pts[:4] + (torch.zeros_like(pts[4]),)
    e, n, Hm, g = track_reduce(T_(Ts), T_(aff), none, planes, rt.K[0])
    assert not e.any() and not n.any() and not Hm.any() and not g.any()
    cut = T_(aff.copy())
    cut[:, 1] = 1000.0
    e, n, Hm, g = track_reduce(T_(Ts), cut, pts, planes, rt.K[0])
    assert torch.equal(e, n * 400.0) and n.min() > 0
    assert not Hm.any() and not g.any()


def test_tdist_track_reduce_plain_f64_agrees():
    """The Student-t K6 in f32 against its own float64 evaluation (the
    card's kernel is held to the same float64 in tests/test_torch_cuda.py):
    the scale's fixed point moves by rounding only. An all-invalid list
    sums to zero."""
    _, rt = _make_refs("dense")
    new_img, _ = render_plane(np.eye(4))
    pt = tpyr.build_pyramid(T_(new_img), 6)
    Ts, aff = _candidates(3)
    planes = tct._planes(pt[0])
    pts = rt.level(0)
    out32 = track_reduce(T_(Ts), T_(aff), pts, planes, rt.K[0], tdist=True)
    out64 = track_reduce(T_(Ts).double(), T_(aff).double(),
                         tuple(p.double() if p.is_floating_point() else p
                               for p in pts),
                         tuple(p.double() for p in planes), rt.K[0],
                         tdist=True)
    for a, b in zip(out32, out64):
        assert _rel(a, b) <= 1e-5
    huber = track_reduce(T_(Ts), T_(aff), pts, planes, rt.K[0])
    assert torch.equal(out32[1], huber[1])      # the same points are good
    none = pts[:4] + (torch.zeros_like(pts[4]),)
    e, n, Hm, g = track_reduce(T_(Ts), T_(aff), none, planes, rt.K[0],
                               tdist=True)
    assert not e.any() and not n.any() and not Hm.any() and not g.any()


@pytest.mark.parametrize("N, C, share", [
    (0, 1, 0), (1, 1, 1), (2048, 1, 2048), (2049, 2, 1025),
    (4800, 3, 1600), (10240, 5, 2048), (16384, 8, 2048),
    (42496, 8, 5312), (10 ** 6, 8, 125000)])
def test_cluster_plan(N, C, share):
    """The card's split of a level (csrc/track_partial.cuh make_plan, as a
    pure function): ~4 points a thread, 1 to 8 CTAs a candidate, from N
    alone; the points stashed in shared memory while they fit (16 B a
    point, 4 more in the t-mode), else read from L2; a t-mode share whose
    r^2 does not fit is refused."""
    from tandem_tpu_torch.ops import track_reduce as tr
    assert tr.cluster_size(N) == C
    for tdist in (False, True):
        plan = tr.cluster_plan(N, tdist)
        assert (plan["C"], plan["share"]) == (C, share)
        per = 16 + 4 * tdist
        assert plan["stash"] == (share * per <= tr.SMEM_MAX)
        assert plan["smem"] == (share * per if plan["stash"]
                                else 4 * share * tdist)
    assert tr.cluster_plan(42496, True)["smem"] == 106240   # 640x480 cap
    assert not tr.cluster_plan(157696, False)["stash"]       # 1280x960 cap
    if N == 10 ** 6:
        with pytest.raises(ValueError):
            tr.check_plan("t", N, True)
    else:
        tr.check_plan("t", N, True)


# --- LM and the entry points ------------------------------------------------

def _pose_close(t_out, j_out, tol=1e-4):
    Tt, Tj = t_out["T"].numpy(), np.asarray(j_out["T"])
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() <= tol, (Tt, Tj)
    assert np.abs(Tt[:3, :3] - Tj[:3, :3]).max() <= tol, (Tt, Tj)


def test_track_frame_matches_jax():
    rj, rt = _make_refs("sparse")
    xi = np.array([0.04, -0.02, 0.03, 0.01, -0.015, 0.008], np.float32)
    new_c2w = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    new_img, _ = render_plane(new_c2w.astype(np.float64))
    aff0 = np.array([1.0, 0.0], np.float32)
    oj = jct.track_frame(rj, jnp.asarray(new_img), jnp.eye(4),
                         jnp.asarray(aff0))
    ot = tct.track_frame(rt, T_(new_img), torch.eye(4), T_(aff0))
    _pose_close(ot, oj)
    assert len(ot["lm_iters"]) == tct.NUM_LEVELS and sum(ot["lm_iters"]) > 0
    for k in ("energy", "num_terms", "valid_frac"):
        assert abs(float(ot[k]) - float(oj[k])) <= 1e-3 * max(
            abs(float(oj[k])), 1.0), k
    np.testing.assert_allclose(ot["flow"].numpy(), np.asarray(oj["flow"]),
                               rtol=1e-3, atol=1e-4)
    T_gt = np.linalg.inv(new_c2w)
    assert np.abs(ot["T"].numpy()[:3, 3] - T_gt[:3, 3]).max() < 5e-3

    cj = jct.calc_res_eval(rj, jnp.asarray(new_img), oj["T"], oj["aff"])
    ct = tct.calc_res_eval(rt, T_(new_img), T_(np.asarray(oj["T"])),
                           T_(np.asarray(oj["aff"])))
    assert float(ct["num_terms"]) == float(cj["num_terms"])
    assert abs(float(ct["energy"]) - float(cj["energy"])) <= 1e-4 * float(
        cj["energy"])


def test_track_frame_multi_perturbations_matches_jax():
    """The retry ladder's 15 rotation perturbations on a 96x128 plane."""
    rj, rt = _make_refs("dense")
    xi = np.array([0.03, 0.0, 0.02, 0.0, 0.01, 0.0], np.float32)
    new_c2w = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    new_img, _ = render_plane(new_c2w.astype(np.float64))
    perts = tct.rotation_perturbations()
    np.testing.assert_array_equal(perts, jct.rotation_perturbations())
    assert perts.shape == (15, 4, 4)
    aff0 = np.array([1.0, 0.0], np.float32)
    oj = jct.track_frame_multi(rj, jnp.asarray(new_img), jnp.asarray(perts),
                               jnp.asarray(aff0))
    ot = tct.track_frame_multi(rt, T_(new_img), T_(perts), T_(aff0))
    _pose_close(ot, oj)
    T_gt = np.linalg.inv(new_c2w)
    assert np.abs(ot["T"].numpy()[:3, 3] - T_gt[:3, 3]).max() < 1e-2


def test_tdist_not_worse_on_depth_outliers_matches_jax():
    """tests/test_coarse_tracker.py::test_tdist_not_worse_on_depth_outliers
    through both packages, both weightings."""
    rng = np.random.RandomState(3)
    ref_img, ref_depth = render_plane(np.eye(4))
    xi = np.array([0.03, -0.015, 0.02, 0.008, -0.01, 0.006], np.float32)
    new_c2w = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    new_img, _ = render_plane(new_c2w.astype(np.float64))
    idepth = 1.0 / ref_depth
    bad = rng.rand(H, W) < 0.20
    idepth = np.where(bad, idepth * rng.uniform(0.25, 4.0, (H, W)),
                      idepth).astype(np.float32)
    ones = np.ones((H, W), np.float32)
    rj = jct.make_tracker_ref(jnp.asarray(ref_img), FX, FY, CX, CY,
                              sparse_idepth=jnp.asarray(idepth),
                              sparse_weight=jnp.asarray(ones))
    rt = tct.make_tracker_ref(T_(ref_img), FX, FY, CX, CY,
                              sparse_idepth=T_(idepth),
                              sparse_weight=T_(ones))
    T_gt = np.linalg.inv(new_c2w)
    aff0 = np.array([1.0, 0.0], np.float32)
    errs = {}
    for tdist in (False, True):
        oj = jct.track_frame(rj, jnp.asarray(new_img), jnp.eye(4),
                             jnp.asarray(aff0), tdist)
        ot = tct.track_frame(rt, T_(new_img), torch.eye(4), T_(aff0), tdist)
        _pose_close(ot, oj)
        errs[tdist] = np.abs(ot["T"].numpy()[:3, 3] - T_gt[:3, 3]).max()
    assert errs[True] < 0.04 and errs[True] <= errs[False] * 1.02, errs


# --- the slice: tracking against the model ----------------------------------

def motion_init(ref_c2w, last_c2w, prev_c2w):
    """FullSystem._motion_model: constant velocity, T_ref->new."""
    pred = last_c2w @ np.linalg.inv(prev_c2w) @ last_c2w
    return (np.linalg.inv(pred) @ ref_c2w).astype(np.float32)


def track_sequence(scene, ref_id, frames, ref, track, to_dev, to_np):
    """Track ``frames`` one after another from the constant-motion
    prediction; returns the c2w estimates (float64)."""
    ref_c2w = scene.c2w(ref_id).astype(np.float64)
    prev = scene.c2w(ref_id - 1).astype(np.float64)
    last = ref_c2w
    aff0 = to_dev(np.array([1.0, 0.0], np.float32))
    est = []
    for f in frames:
        out = track(ref, to_dev(scene.gray(f)),
                    to_dev(motion_init(ref_c2w, last, prev)), aff0)
        c2w = ref_c2w @ np.linalg.inv(to_np(out["T"]).astype(np.float64))
        est.append(c2w)
        prev, last = last, c2w
    return est


def gt_errors(scene, frames, est):
    """Per frame: camera position error (m), worst rotation entry error."""
    out = []
    for f, c2w in zip(frames, est):
        gt = scene.c2w(f).astype(np.float64)
        out.append((float(np.linalg.norm(c2w[:3, 3] - gt[:3, 3])),
                    float(np.abs(c2w[:3, :3] - gt[:3, :3]).max())))
    return out


FUSE = range(0, 7)
REF_ID = 6
TRACK = list(range(7, 15))


def _port_model_ref(scene):
    cfg = ttsdf.TsdfConfig()
    vol = ttsdf.create_volume(cfg, "cpu")
    K = T_(scene.K)
    for i in FUSE:
        d, p = T_(scene.depth(i)), T_(scene.c2w(i))
        rgb = T_(np.ascontiguousarray(scene.bgr(i)[..., ::-1],
                                      dtype=np.float32))
        ttsdf.allocate_blocks(cfg, vol, d, K, p)
        ttsdf.integrate(cfg, vol, d, rgb, K, p)
    pose = T_(scene.c2w(REF_ID))
    slots, counts = ttsdf.surface_axis_slots(cfg, vol, K, pose,
                                             scene.height, scene.width)
    rdepth = ttsdf.render_depth_splat(cfg, vol, K, pose, scene.height,
                                      scene.width, axis_slots=slots,
                                      axis_counts=counts.tolist())
    idp, w = tct.splat_depth_to_ref(rdepth, pose, pose, K, scene.height,
                                    scene.width, stride=3)
    return tct.make_tracker_ref(T_(scene.gray(REF_ID)), scene.fx, scene.fy,
                                scene.cx, scene.cy, dense_idepth=idp,
                                dense_weight=w), rdepth


def _jax_model_ref(scene):
    cfg = jtsdf.TsdfConfig()
    vol = jtsdf.create_volume(cfg)
    K = jnp.asarray(scene.K)
    for i in FUSE:
        d, p = jnp.asarray(scene.depth(i)), jnp.asarray(scene.c2w(i))
        rgb = jnp.asarray(scene.bgr(i)[..., ::-1].astype(np.float32))
        vol = jtsdf.allocate_blocks(cfg, vol, d, K, p)
        vol = jtsdf.integrate(cfg, vol, d, rgb, K, p)
    n = int(vol.n_allocated)
    pose = jnp.asarray(scene.c2w(REF_ID))
    n_pad = -(-max(n, 1) // 2048) * 2048
    slots, counts = jtsdf.surface_axis_slots(cfg, vol, K, pose, scene.height,
                                             scene.width, n_pad)
    rdepth = jtsdf.render_depth_splat(
        cfg, vol, K, pose, scene.height, scene.width, n_allocated=n,
        axis_slots=slots, axis_counts=[int(c) for c in np.asarray(counts)])
    idp, w = jct.splat_depth_to_ref(rdepth, pose, pose, K, scene.height,
                                    scene.width, stride=3)
    return jct.make_tracker_ref(jnp.asarray(scene.gray(REF_ID)), scene.fx,
                                scene.fy, scene.cx, scene.cy,
                                dense_idepth=idp, dense_weight=w), rdepth


def test_track_against_the_model():
    """Fuse GT depths 0-6 (TsdfConfig defaults), render at frame 6 with the
    axis-culled splat, build the dense reference and track frames 7-14 with
    both packages: per-frame poses agree within 1e-4 and both stay within
    5 mm of GT (the JAX package gets ~1 mm here)."""
    scene = ReplicaScene(FIXTURE)
    ref_t, rd_t = _port_model_ref(scene)
    ref_j, rd_j = _jax_model_ref(scene)
    close = np.abs(rd_t.numpy() - np.asarray(rd_j)) <= 1e-4
    assert (rd_t.numpy() > 0).mean() > 0.9 and close.mean() >= 0.995
    est_t = track_sequence(scene, REF_ID, TRACK, ref_t, tct.track_frame,
                           T_, lambda x: x.numpy())
    est_j = track_sequence(scene, REF_ID, TRACK, ref_j, jct.track_frame,
                           jnp.asarray, np.asarray)
    for a, b in zip(est_t, est_j):
        assert np.abs(a[:3, 3] - b[:3, 3]).max() <= 1e-4, (a, b)
        assert np.abs(a[:3, :3] - b[:3, :3]).max() <= 1e-4, (a, b)
    for errs in (gt_errors(scene, TRACK, est_t),
                 gt_errors(scene, TRACK, est_j)):
        assert max(e for e, _ in errs) < 5e-3, errs


def mvs_window_args(scene, window):
    """(bgrs, cam_to_worlds, depth_min, depth_max, next_ref_c2w) of one
    backend call; the depth range spans the window's GT depths."""
    depths = [scene.depth(i) for i in window]
    valid = np.concatenate([d[d > 0] for d in depths])
    return ([scene.bgr(i) for i in window], [scene.c2w(i) for i in window],
            float(valid.min()), float(valid.max()), scene.c2w(window[-1]))


def mvs_reference(scene, backend, splat, make_ref, to_dev):
    """Two backend calls, then the dense tracking reference at the newest
    keyframe of the second window. Returns (ref, its frame id)."""
    for window in scene.windows[:2]:
        backend.call(*mvs_window_args(scene, window))
    dm = backend.get_tracking_depth_map()
    ref_id = scene.windows[1][-1]
    K = to_dev(scene.K)
    c2w = to_dev(np.asarray(dm["c2w"], np.float32))
    idp, w = splat(dm["depth"], c2w, c2w, K, scene.height, scene.width,
                   stride=3)
    return make_ref(to_dev(scene.gray(ref_id)), scene.fx, scene.fy,
                    scene.cx, scene.cy, dense_idepth=idp,
                    dense_weight=w), ref_id


@pytest.mark.slow
def test_track_against_the_mvs_model():
    import json

    from tandem_tpu.models.cva_mvsnet import CvaMVSNet as JCvaMVSNet
    from tandem_tpu.pipeline.backend import TandemBackend as JTandemBackend
    from tandem_tpu.pipeline.mvsnet_runner import MvsnetRunner as JRunner
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner

    scene = ReplicaScene(FIXTURE)
    unit = "exported/tandem"
    with open(f"{unit}/model_config.json") as f:
        cfg = json.load(f)
    variables = load_variables(f"{unit}/model_variables.pkl")
    Hs, Ws = scene.height, scene.width
    tb = TandemBackend(MvsnetRunner(CvaMVSNet(**cfg), variables, Hs, Ws,
                                    view_num=7, device="cpu"),
                       ttsdf.TsdfConfig(),
                       scene.K, Hs, Ws)
    jcfg = {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg.items()}
    jb = JTandemBackend(JRunner(JCvaMVSNet(**jcfg), variables, Hs, Ws,
                                view_num=7), jtsdf.TsdfConfig(), scene.K,
                        Hs, Ws, mesh_extraction_freq=0)
    ref_t, ref_id = mvs_reference(scene, tb, tct.splat_depth_to_ref,
                                  tct.make_tracker_ref, T_)
    ref_j, _ = mvs_reference(scene, jb, jct.splat_depth_to_ref,
                             jct.make_tracker_ref, jnp.asarray)
    frames = list(range(ref_id + 1, ref_id + 9))
    est_t = track_sequence(scene, ref_id, frames, ref_t, tct.track_frame,
                           T_, lambda x: x.numpy())
    est_j = track_sequence(scene, ref_id, frames, ref_j, jct.track_frame,
                           jnp.asarray, np.asarray)
    err_t = gt_errors(scene, frames, est_t)
    err_j = gt_errors(scene, frames, est_j)
    # The MVSNet depths differ by ~1e-6 between the frameworks and LM
    # accept decisions can flip on near-ties: measured 4.4e-4 m apart.
    parity = max(np.abs(a - b).max() for a, b in zip(est_t, est_j))
    assert parity <= 2e-3, parity
    assert max(e for e, _ in err_j) <= MVS_TRACK_BOUND
    assert max(e for e, _ in err_t) <= MVS_TRACK_BOUND
