"""Pixel selection and immature points (K8): the PyTorch port against the
JAX package on the CPU, on seeded inputs and ``tests/test_points.py``'s
textured plane (96x128). Tolerances, with their reasons:
- ``select_pixels``: exact (integer choices; the block median is the same
  midpoint and ties go to the first pixel in both);
- ``make_immature``: uv exact, pattern colours 1e-4 absolute (bilinear
  samples of 0-255 intensities, four products summed in another order);
- ``trace_points``: status exact; id_min, id_max and last_px 1e-4 relative
  to the largest |entry|, quality 1e-3 relative (a ratio of two SSDs of
  f32 samples);
- ``activate_points``: the ok mask exact, idepth 1e-4 relative.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tandem_tpu.core.se3 import se3_exp
from tandem_tpu.tracking import immature as jim
from tandem_tpu.tracking import point_selection as jps
from tandem_tpu_torch.tracking import immature as tim
from tandem_tpu_torch.tracking import point_selection as tps
from tests.test_coarse_tracker import CX, CY, FX, FY, H, W, render_plane

K = (FX, FY, CX, CY)


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


@pytest.mark.parametrize("shape,potential,factor", [
    ((96, 128), 4, 1.0), ((96, 128), 1, 0.4), ((48, 64), 2, 0.2),
    ((100, 140), 8, 1.0), ((100, 140), 1, 0.2)])
def test_select_pixels_exact(shape, potential, factor):
    rng = np.random.RandomState(shape[0] + potential)
    g2 = (rng.rand(*shape) ** 4 * 3000).astype(np.float32)
    g2[rng.rand(*shape) < 0.1] = 400.0          # ties inside the cells
    a = tps.select_pixels(torch.from_numpy(g2), 32, potential,
                          factor).numpy()
    b = np.asarray(jps.select_pixels(jnp.asarray(g2), 32, potential, factor))
    assert np.array_equal(a, b)
    assert a.any()


def _pair():
    """Host frame at the identity, targets moved along x (a 12 cm and an
    18 cm baseline), points on a 12-pixel grid."""
    host = np.eye(4, dtype=np.float32)
    img0, _ = render_plane(host)
    tgts = []
    for tx in (0.12, 0.18):
        c2w = np.asarray(se3_exp(jnp.array([tx, 0.01, 0, 0, 0.01, 0],
                                           jnp.float32)))
        tgts.append((c2w, render_plane(c2w)[0]))
    ys, xs = np.mgrid[10:H - 10:12, 10:W - 10:12]
    uv = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.float32)
    return host, img0, tgts, uv


def _check_points(a, b):
    assert np.array_equal(a.status.numpy(), np.asarray(b.status))
    assert np.array_equal(a.valid.numpy(), np.asarray(b.valid))
    for name in ("id_min", "id_max", "last_px"):
        assert _rel(getattr(a, name).numpy(), getattr(b, name)) < 1e-4, name
    assert _rel(a.quality.numpy(), b.quality) < 1e-3


def test_make_trace_activate():
    host, img0, tgts, uv = _pair()
    jp = jim.make_immature(jnp.asarray(uv), jnp.asarray(img0), 0.05, 2.0)
    tp = tim.make_immature(torch.from_numpy(uv), torch.from_numpy(img0),
                           0.05, 2.0)
    assert np.array_equal(tp.uv.numpy(), np.asarray(jp.uv))
    assert np.abs(tp.color.numpy() - np.asarray(jp.color)).max() < 1e-4
    _check_points(tp, jp)

    th = torch.from_numpy(host)
    for c2w, img in tgts:
        jp = jim.trace_points(jp, jnp.asarray(host), jnp.asarray(c2w),
                              jnp.asarray(img), K)
        tp = tim.trace_points(tp, th, torch.from_numpy(c2w),
                              torch.from_numpy(img), K)
        _check_points(tp, jp)
    assert (tp.status.numpy() == tim.STATUS_GOOD).mean() > 0.5

    c2w, img = tgts[-1]
    jid, jok = jim.activate_points(jp, jnp.asarray(host), jnp.asarray(c2w),
                                   jnp.asarray(img), K)
    tid, tok = tim.activate_points(tp, th, torch.from_numpy(c2w),
                                   torch.from_numpy(img), K)
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    assert _rel(tid.numpy(), jid) < 1e-4
    assert tok.numpy().any()


def test_trace_skips_tiny_baselines_and_out_of_view():
    """A target at the host pose (SKIPPED keeps status and interval) and
    one looking away (every sample out of view: OOB)."""
    host, img0, _, uv = _pair()
    jp = jim.make_immature(jnp.asarray(uv), jnp.asarray(img0), 0.05, 2.0)
    tp = tim.make_immature(torch.from_numpy(uv), torch.from_numpy(img0),
                           0.05, 2.0)
    away = np.asarray(se3_exp(jnp.array([0.2, 0, 0, 0, 1.2, 0],
                                        jnp.float32)))
    for c2w in (host, away):
        jp = jim.trace_points(jp, jnp.asarray(host), jnp.asarray(c2w),
                              jnp.asarray(img0), K)
        tp = tim.trace_points(tp, torch.from_numpy(host),
                              torch.from_numpy(c2w), torch.from_numpy(img0),
                              K)
        _check_points(tp, jp)
    assert (tp.status.numpy() == tim.STATUS_OOB).mean() > 0.5
