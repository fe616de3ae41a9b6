"""Windowed photometric BA (K7 and the LM around it): the PyTorch port
against the JAX package on the CPU.

The window is ``tests/test_ba.py``'s synthetic plane scene (4 frame slots,
256 point slots, 96x128), built once with the JAX package and copied into
the port's state. Tolerances, with their reasons:
- residuals, Jacobians and weights of ``_system_terms``: 1e-4 relative to
  the largest |entry| (the same f32 formulas; the bilinear sample reads the
  planes where the JAX package reads a corner-packed table, and 3-term
  products may sum in another order); the active mask exact; the total
  energy 1e-4 relative;
- ``_assemble``, ``_total_energy`` and ``ba_log_system``'s H and b: 1e-4
  relative to the largest |entry| (sums over 16k residual rows in another
  order); its nullspaces as ``gauge_nullspaces``, its residual count
  exact;
- ``ba_iterate``: poses 1e-4, affine 1e-4 relative to the largest (the
  offsets b are in grey levels, up to ~2.4 here), inverse depths 1e-3
  relative to the largest (an LM step solves a 36-dimensional damped
  system in f32);
  the energy 1e-3 relative (near convergence it is a sum of thousands of
  small squared residuals);
- ``gauge_nullspaces``: 1e-3 absolute (finite differences at eps 1e-4 of
  f32 exponentials: the entries carry ~1e-3 of rounding);
- ``remove_outliers``: the kept mask exact;
- ``marginalize_frame``: Hm and bm 3e-3 relative to the largest |entry|
  (the Schur complement inverts the frame's damped 8x8 block and the
  orthogonalization subtracts projections of entries up to 4e7 in f32:
  1.1e-4 to 1.3e-3 seen), frame and point masks exact.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tandem_tpu.tracking import ba as jba
from tandem_tpu_torch.tracking import ba as tba
from tests.test_ba import K, _build_scene

REL = 1e-4


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


def to_torch(state) -> tba.BAState:
    """The JAX package's BAState as the port's (int32 frame slots become
    int64 indices)."""
    out = {}
    for name in jba.BAState._fields:
        x = np.asarray(getattr(state, name))
        t = torch.from_numpy(np.array(x))
        out[name] = t.long() if name == "pt_frame" else t
    return tba.BAState(**out)


def _window(invalid_frame=None, seed=1):
    state, images, _, _ = _build_scene(np.random.RandomState(seed))
    if invalid_frame is not None:
        state = state._replace(
            frame_valid=state.frame_valid.at[invalid_frame].set(False))
    return state, images, to_torch(state), torch.from_numpy(
        np.array(images))


@pytest.mark.parametrize("newest_slot,invalid", [(None, None), (3, None),
                                                 (2, 1), (1, 1)])
def test_system_terms(newest_slot, invalid):
    """(1, 1): the newest slot is an invalid frame, so every pair energy
    that feeds the quantile is NaN and the threshold falls back to
    144 * 8."""
    js, jimg, ts, timg = _window(invalid)
    jout = jba._system_terms(js, jimg, K, newest_slot)
    tout = tba._system_terms(ts, timg, K, newest_slot)
    names = ("r", "Jf", "Ji", "J_K", "w", "active", "e_total")
    for name, a, b in zip(names, tout, jout):
        if name == "active":
            assert np.array_equal(a.numpy(), np.asarray(b))
        else:
            assert _rel(a.numpy(), b) < REL, name


def test_nanquantile_matches_jax():
    rng = np.random.RandomState(0)
    for n_nan in (0, 5, 199, 200):
        v = rng.rand(10, 20).astype(np.float32) * 100
        v.reshape(-1)[rng.permutation(200)[:n_nan]] = np.nan
        a = float(tba._nanquantile(torch.from_numpy(v), 0.7))
        b = float(jnp.nanquantile(jnp.asarray(v), 0.7))
        assert (np.isnan(a) and np.isnan(b)) or a == b, (n_nan, a, b)


def test_assemble():
    js, jimg, ts, timg = _window()
    jout = jba._assemble(js, *jba._system_terms(js, jimg, K)[:5])
    tout = tba._assemble(ts, *tba._system_terms(ts, timg, K)[:5])
    for i, (a, b) in enumerate(zip(tout, jout)):
        assert _rel(a.numpy(), b) < REL, i
    assert _rel(tba._total_energy(ts, timg, K).numpy(),
                jba._total_energy(js, jimg, K)) < REL
    # The debug-log system (DSO's lastHS/lastbS, calib columns first).
    H, b, ns, n = tba.ba_log_system(ts, timg, K)
    jH, jb, jns, jn = jba.ba_log_system(js, jimg, K)
    assert _rel(H.numpy(), jH) < REL and _rel(b.numpy(), jb) < REL
    assert np.abs(ns.numpy() - np.asarray(jns)).max() < 1e-3
    assert int(n) == int(jn)


@pytest.mark.parametrize("iters", [1, 4])
def test_ba_iterate(iters):
    js, jimg, ts, timg = _window()
    jst, je = jba.ba_iterate(js, jimg, K, iters=iters, newest_slot=3)
    tst, te = tba.ba_iterate(ts, timg, K, iters=iters, newest_slot=3)
    assert np.abs(tst.poses.numpy() - np.asarray(jst.poses)).max() < 1e-4
    assert _rel(tst.aff.numpy(), jst.aff) < 1e-4
    assert _rel(tst.pt_idepth.numpy(), jst.pt_idepth) < 1e-3
    assert _rel(tst.calib.numpy() + 1.0, np.asarray(jst.calib) + 1.0) < 1e-4
    assert abs(float(te) - float(je)) <= 1e-3 * abs(float(je))


def test_gauge_nullspaces():
    js, _, ts, _ = _window(invalid_frame=2)
    a = tba.gauge_nullspaces(ts.poses, ts.frame_valid).numpy()
    b = np.asarray(jba.gauge_nullspaces(js.poses, js.frame_valid))
    assert a.shape == b.shape == (4 * 8 + 4, 9)
    assert np.abs(a - b).max() < 1e-3


def test_remove_outliers():
    js, jimg, ts, timg = _window()
    # Corrupt some colours so that points become outliers.
    col = np.asarray(js.pt_color).copy()
    col[::7] += 60.0
    js = js._replace(pt_color=jnp.asarray(col))
    ts = ts._replace(pt_color=torch.from_numpy(col))
    a = tba.remove_outliers(ts, timg, K).pt_valid.numpy()
    b = np.asarray(jba.remove_outliers(js, jimg, K).pt_valid)
    assert np.array_equal(a, b)
    assert b.sum() < np.asarray(js.pt_valid).sum()


@pytest.mark.parametrize("frame", [0, 2])
def test_marginalize_frame(frame):
    js, jimg, ts, timg = _window()
    jst, _ = jba.ba_iterate(js, jimg, K, iters=2, newest_slot=3)
    tst = to_torch(jst)
    a = tba.marginalize_frame(tst, timg, K, frame)
    b = jba.marginalize_frame(jst, jimg, K, frame)
    assert _rel(a.Hm.numpy(), b.Hm) < 3e-3
    assert _rel(a.bm.numpy(), b.bm) < 3e-3
    assert np.array_equal(a.frame_valid.numpy(), np.asarray(b.frame_valid))
    assert np.array_equal(a.pt_valid.numpy(), np.asarray(b.pt_valid))


def test_residual_one_and_analytic_jacobians():
    """``_residual_one`` against the JAX package's on the same point and
    target (1e-4 absolute, 0-255 intensities), and the analytic Jacobians
    of the port's ``_system_terms`` against central differences (step
    1e-2) of the port's ``_residual_one``, with tests/test_ba_jacobians.py's
    bar (relative Frobenius error < 0.10, or absolute < 2.5: the analytic
    form uses interpolated central-difference gradients, DSO's estimator)."""
    js, jimg, ts, timg = _window()
    r, Jf, Ji, J_K, w, _, _ = tba._system_terms(ts, timg, K)
    h = 1e-2
    z8, z4 = torch.zeros(8), torch.zeros(4)
    checked = 0
    for n in range(0, 256, 37):
        host = int(ts.pt_frame[n])
        for f in range(4):
            if f == host or not bool((w[n, f] > 0).all()):
                continue

            def res(dh=z8, dt=z8, di=0.0, dk=z4):
                return tba._residual_one(
                    dh, dt, ts.pt_idepth[n] + di, ts.poses[host], ts.poses[f],
                    ts.aff[host], ts.aff[f], ts.pt_uv[n], ts.pt_color[n],
                    timg[f], K, dk)[0]
            jr, _ = jba._residual_one(
                jnp.zeros(8), jnp.zeros(8), js.pt_idepth[n], js.poses[host],
                js.poses[f], js.aff[host], js.aff[f], js.pt_uv[n],
                js.pt_color[n], jimg[f], K)
            assert np.abs(res().numpy() - np.asarray(jr)).max() < 1e-4
            assert np.abs(res().numpy() - r[n, f].numpy()).max() < 1e-3

            def fd(key, k, size):
                e = torch.zeros(size)
                e[k] = h
                return (res(**{key: e}) - res(**{key: -e})) / (2 * h)
            blocks = (
                (Jf[n, f, :, :8], torch.stack([fd("dh", k, 8)
                                               for k in range(8)], -1)),
                (Jf[n, f, :, 8:], torch.stack([fd("dt", k, 8)
                                               for k in range(8)], -1)),
                (Ji[n, f], (res(di=h) - res(di=-h)) / (2 * h)),
                (J_K[n, f], torch.stack([fd("dk", k, 4)
                                         for k in range(4)], -1)))
            for mine, ref in blocks:
                diff = float(torch.linalg.norm(mine - ref))
                denom = max(float(torch.linalg.norm(ref)), 1e-6)
                assert diff / denom < 0.10 or diff < 2.5, (diff, denom)
            checked += 1
    assert checked > 5
