"""The joint monocular initializer (K11 and its LM): the PyTorch port
against the JAX package on the CPU, on frames of
``tests/test_full_system.make_sequence`` (96x128), and the port's own
convergence on ``tests/test_initializer.py``'s two-layer scene.
Tolerances, with their reasons:
- ``make_initializer``: the point lists (pu, pv, pcolor, pvalid) exact
  (integer selections and direct lookups);
- ``_calc_res_gs``: energies and the 8x8 system 1e-4 relative to the
  largest |entry| (sums over ~8k x 8 terms in another order), the good
  mask exact;
- ``initializer_track`` over 4 frames: T 1e-4 absolute, iR and idepth 1e-3
  relative to the largest (each level runs up to 50 LM steps whose accept
  tests compare f32 energies), snapped and done exact.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tandem_tpu.core.se3 import se3_exp
from tandem_tpu.core.pyramid import build_pyramid as jbuild
from tandem_tpu.tracking import coarse_tracker as jct
from tandem_tpu.tracking import initializer as jin
from tandem_tpu_torch.core.pyramid import build_pyramid as tbuild
from tandem_tpu_torch.core.pyramid import pyramid_intrinsics
from tandem_tpu_torch.tracking import initializer as tin
from tests.test_coarse_tracker import CX, CY, FX, FY, H, W
from tests.test_full_system import make_sequence
from tests import test_initializer as ti


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this module: the tier-1 run puts six pytest
    workers on the CPU, and torch's default of one thread per core in each
    makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_make_initializer_exact():
    _, images = make_sequence(n=1)
    js = jin.make_initializer(jnp.asarray(images[0]), FX, FY, CX, CY)
    ts = tin.make_initializer(torch.from_numpy(images[0]), FX, FY, CX, CY)
    for lvl in range(tin.NUM_LEVELS):
        for name in ("pu", "pv", "pcolor", "pvalid", "is_good"):
            a = getattr(ts, name)[lvl].numpy()
            b = np.asarray(getattr(js, name)[lvl])
            assert np.array_equal(a, b), (name, lvl)
    assert ts.pvalid[0].numpy().any()


def test_calc_res_gs():
    """One evaluation at level 0 from a moved pose, with bad points and a
    prior in the capped (snapped) regime."""
    _, images = make_sequence(n=4)
    js = jin.make_initializer(jnp.asarray(images[0]), FX, FY, CX, CY)
    ts = tin.make_initializer(torch.from_numpy(images[0]), FX, FY, CX, CY)
    xi = np.array([0.02, -0.01, 0.01, 0.005, -0.004, 0.002], np.float32)
    T = np.asarray(se3_exp(jnp.asarray(xi)))
    aff = np.array([0.01, 2.0], np.float32)
    rng = np.random.RandomState(0)
    N = js.pu[0].shape[0]
    idepth = (1.0 + 0.2 * rng.randn(N)).astype(np.float32)
    iR = (1.0 + 0.1 * rng.randn(N)).astype(np.float32)
    good = np.asarray(js.is_good[0]) & (rng.rand(N) > 0.1)
    energy = (rng.rand(N) * 100).astype(np.float32)
    jpyr = jbuild(jnp.asarray(images[3]), 6)
    tpyr = tbuild(torch.from_numpy(images[3]), 6)
    Kl = pyramid_intrinsics(FX, FY, CX, CY, 6)[0]
    jconst = (js.pu[0], js.pv[0], js.pcolor[0], js.pvalid[0],
              jct._pack_level(jpyr[0]["img"], jpyr[0]["gx"], jpyr[0]["gy"]),
              H, W, Kl)
    tconst = (ts.pu[0], ts.pv[0], ts.pcolor[0], ts.pvalid[0],
              (tpyr[0]["img"], tpyr[0]["gx"], tpyr[0]["gy"]), H, W, Kl)
    jres = jax.jit(lambda T, aff, idepth, good, energy, iR, snapped:
                   jin._calc_res_gs(T, aff, idepth, good, energy, iR, jconst,
                                    snapped))
    for snapped in (False, True):
        a = tin._calc_res_gs(torch.from_numpy(T), torch.from_numpy(aff),
                             torch.from_numpy(idepth), torch.from_numpy(good),
                             torch.from_numpy(energy), torch.from_numpy(iR),
                             tconst, torch.tensor(snapped))
        b = jres(jnp.asarray(T), jnp.asarray(aff), jnp.asarray(idepth),
                 jnp.asarray(good), jnp.asarray(energy), jnp.asarray(iR),
                 jnp.asarray(snapped))
        for k in ("good", "snapped"):
            assert np.array_equal(a[k].numpy(), np.asarray(b[k])), k
        for k in ("E_photo", "E_alpha", "energy", "H", "b", "Hsc", "bsc",
                  "Jb", "lastH", "maxstep"):
            assert _rel(a[k].numpy(), b[k]) < 1e-4, (k, snapped)


def test_initializer_track_matches_jax():
    _, images = make_sequence(n=5)
    js = jin.make_initializer(jnp.asarray(images[0]), FX, FY, CX, CY)
    ts = tin.make_initializer(torch.from_numpy(images[0]), FX, FY, CX, CY)
    for img in images[1:]:
        js, jd = jin.initializer_track(js, jnp.asarray(img), FX, FY, CX, CY,
                                       (H, W))
        ts, td = tin.initializer_track(ts, torch.from_numpy(img), FX, FY,
                                       CX, CY, (H, W))
        assert np.abs(ts.T.numpy() - np.asarray(js.T)).max() < 1e-4
        assert bool(td) == bool(jd)
        assert bool(ts.snapped) == bool(js.snapped)
        assert int(ts.snapped_at) == int(js.snapped_at)
        for lvl in range(tin.NUM_LEVELS):
            assert _rel(ts.iR[lvl].numpy(), js.iR[lvl]) < 1e-3, lvl
            assert _rel(ts.idepth[lvl].numpy(), js.idepth[lvl]) < 1e-3, lvl


def test_initializer_converges_two_layers():
    """The port alone, as tests/test_initializer.py holds the JAX package:
    snapped and done within 12 frames, level-0 idepth within 3% (median,
    after scale alignment) on a scene with a depth step."""
    ref_img, ref_depth = ti.render_two_planes(np.eye(4))
    st = tin.make_initializer(torch.from_numpy(ref_img), ti.FX, ti.FY,
                              ti.CX, ti.CY)
    done, n_frames = False, 0
    for i in range(1, 13):
        s = 0.022 * i
        xi = np.array([s, 0.5 * s, 0.15 * s, 0.05 * s, -0.04 * s, 0.02 * s],
                      np.float32)
        img, _ = ti.render_two_planes(np.asarray(se3_exp(jnp.array(xi))))
        st, d = tin.initializer_track(st, torch.from_numpy(img), ti.FX,
                                      ti.FY, ti.CX, ti.CY, (ti.H, ti.W))
        n_frames = i
        if bool(d):
            done = True
            break
    assert bool(st.snapped), "never snapped"
    assert done and n_frames <= 12, n_frames
    iR = st.iR[0].numpy()
    good = st.is_good[0].numpy() & st.pvalid[0].numpy()
    pu = st.pu[0].numpy().astype(int)
    pv = st.pv[0].numpy().astype(int)
    gt_id = 1.0 / ref_depth[pv[good], pu[good]]
    est = iR[good]
    scale = np.median(gt_id / est)
    assert np.median(np.abs(est * scale - gt_id) / gt_id) < 0.03
    assert good.sum() > 200
