"""The coarse tracker's LM level on the CPU (``ops/track_lm.py``): the plain
step and level against the loop they replace and against the JAX package,
and the card kernel's decoupled loop (each candidate on its own, the loop's
condition resolved afterwards from the recorded states) in plain PyTorch.

Inputs are made with numpy from a seed (``torch_cases._track_case``: a
textured level image with its gradients, points with a 10% invalid and a 5%
outlier share, candidate poses within ~1 cm / 0.6 degrees of the identity).
Tolerances, with their reasons:
- against the per-iteration loop that ``lm_level_plain`` replaced (the
  parent's ``_lm_level``, copied below): bit for bit, the same torch ops in
  the same order; so is the decoupled loop (``lm_history_plain`` +
  ``lm_level_from_history``) against ``lm_level_plain``;
- against the JAX package's ``_lm_level``: poses and affine within 1e-4, as
  ``tests/test_torch_tracker.py::_pose_close`` (the JAX package samples a
  corner-packed table and sums in another order, and an LM accept decision
  can flip on a near-tie); energies within 1e-3 relative, counts exact.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tandem_tpu.tracking import coarse_tracker as jct
from tandem_tpu_torch.core.pyramid import gradients
from tandem_tpu_torch.core.se3 import se3_exp
from tandem_tpu_torch.ops import track_lm as tl
from tandem_tpu_torch.ops.linalg import solve_gauss_jordan_batched
from tandem_tpu_torch.tracking import coarse_tracker as tct
from torch_cases import _track_case

CPU = torch.device("cpu")
H, W = 61, 83


def _bwhere(cond, a, b):
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def loop_lm_level(T, aff, pts, planes, Klvl, max_iter, tdist=False):
    """The per-iteration loop ``lm_level_plain`` replaced: the JAX
    ``while_loop`` as a Python loop whose condition is read every
    iteration."""
    B = T.shape[0]
    e0, n0, Hm, g = tct._energy_and_system(T, aff, pts, planes, Klvl, tdist)
    T_in, aff_in = T, aff
    e, n = e0, n0
    done = torch.zeros(B, dtype=torch.bool)
    lam = torch.full((B,), 0.01, dtype=torch.float32)
    eye = torch.eye(8)
    it = 0
    while it < max_iter and bool((~done & (lam < 1e4)).any()):
        diag = torch.diagonal(Hm, dim1=-2, dim2=-1)
        Hl = Hm + lam[:, None, None] * (diag[:, :, None] * eye) + 1e-5 * eye
        dx = -solve_gauss_jordan_batched(Hl, g, 8)
        T_new = se3_exp(dx[:, :6]) @ T
        aff_new = aff + dx[:, 6:]
        e_new, n_new, H_new, g_new = tct._energy_and_system(
            T_new, aff_new, pts, planes, Klvl, tdist)
        e_old_n = e / torch.clamp(n, min=1.0)
        e_new_n = e_new / torch.clamp(n_new, min=1.0)
        accept = (e_new_n < e_old_n) & ~done
        small = ((dx.abs().amax(-1) < 1e-5)
                 | (accept & (e_old_n - e_new_n
                              < 1e-4 * torch.clamp(e_old_n, min=1e-6))))
        it += 1
        lam = torch.where(done, lam, torch.where(accept, lam * 0.5,
                                                 lam * 4.0))
        done = done | small
        T = _bwhere(accept, T_new, T)
        aff = _bwhere(accept, aff_new, aff)
        e = torch.where(accept, e_new, e)
        n = torch.where(accept, n_new, n)
        Hm = _bwhere(accept, H_new, Hm)
        g = _bwhere(accept, g_new, g)
    enough = n0 >= 32.0
    return _bwhere(enough, T, T_in), _bwhere(enough, aff, aff_in), e, n, it


def _case(kind: str):
    """(T, aff, pts, planes, K, max_iter, tdist) of a named case."""
    B = {"B1": 1, "B15": 15}.get(kind, 5)
    T, aff, pts, planes, K = _track_case(CPU, 2000, B, H, W, seed=B)
    if kind == "lam_explodes":
        # A new frame of noise: steps keep failing until a candidate's
        # damping passes 1e4 (seed 0: candidate 3 stops there at step 34).
        T, aff, pts, planes, K = _track_case(CPU, 2000, B, H, W, seed=0)
        img = torch.from_numpy((np.random.RandomState(0).rand(H, W) * 255)
                               .astype(np.float32))
        planes = (img,) + tuple(p.contiguous() for p in gradients(img))
    if kind == "few_terms":             # n0 < 32: the level keeps its input
        keep = torch.zeros_like(pts[4])
        keep[:30] = True
        pts = pts[:4] + (pts[4] & keep,)
    return T, aff, pts, planes, K, 50, kind == "tdist"


CASES = ["B1", "B5", "B15", "lam_explodes", "few_terms", "tdist"]


@pytest.mark.parametrize("kind", CASES)
def test_lm_level_plain_equals_the_loop(kind):
    T, aff, pts, planes, K, max_iter, tdist = _case(kind)
    got = tl.lm_level_plain(T, aff, pts, planes, K, max_iter, tdist)
    ref = loop_lm_level(T, aff, pts, planes, K, max_iter, tdist)
    for a, b in zip(got[:4], ref[:4]):
        assert torch.equal(a, b)
    assert int(got[4]) == ref[4] > 0
    if kind == "lam_explodes":
        s = tl.lm_init_plain(T, aff, pts, planes, K, max_iter)
        while s.active:
            s = tl.lm_step_plain(s, pts, planes, K, max_iter)
        assert s.it < max_iter and bool((~s.done & (s.lam >= 1e4)).any())
    if kind == "few_terms":
        n0 = tl.track_reduce_plain(T, aff, pts, planes, K)[1]
        assert bool((n0 < 32).all())
        assert torch.equal(got[0], T) and torch.equal(got[1], aff)


def test_lm_step_is_a_noop_once_inactive():
    T, aff, pts, planes, K, max_iter, _ = _case("B5")
    s = tl.lm_init_plain(T, aff, pts, planes, K, max_iter)
    while s.active:
        s = tl.lm_step_plain(s, pts, planes, K, max_iter)
    assert 0 < s.it < max_iter
    after = s
    for _ in range(3):
        after = tl.lm_step_plain(after, pts, planes, K, max_iter)
    for a, b in zip(after, s):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_lm_state_pack_roundtrip():
    """The record layout (a candidate's state as the kernel reads and
    records it) holds every field of the plain state, n0 and live."""
    T, aff, pts, planes, K, max_iter, _ = _case("B5")
    s = tl.lm_init_plain(T, aff, pts, planes, K, max_iter)
    s = tl.lm_step_plain(s, pts, planes, K, max_iter)
    rec = tl.pack_state(s)
    assert rec.shape == (5, tl.RECORD) and rec.dtype == torch.float32
    back = tl.unpack_state(rec, s.it, max_iter)
    for a, b in zip(back, s):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    assert torch.equal(tl.record_view(rec, "n0"), s.n)
    assert torch.equal(tl.record_view(rec, "live") != 0,
                       ~s.done & (s.lam < tl.LAM_MAX))
    n0 = torch.arange(5.0)
    assert torch.equal(tl.record_view(tl.pack_state(s, n0), "n0"), n0)
    # the padding after the fields, as csrc/track_lm.cu LmState
    assert sum(torch.Size(sh).numel() for _, sh in tl.RECORD_FIELDS) == 122
    assert not rec[:, 122:].any()


@pytest.mark.parametrize("kind", CASES)
def test_decoupled_loop_equals_lm_level_plain(kind):
    """The kernel's loop in plain PyTorch: every candidate steps until it
    is done or out of steps whatever the others do, then K (the first step
    with no live candidate) picks each one's state; bit for bit
    lm_level_plain. Every recorded step up to K is lm_step_plain of the
    step before it (the card's per-step check reads the history so)."""
    T, aff, pts, planes, K, max_iter, tdist = _case(kind)
    hist, last = tl.lm_history_plain(T, aff, pts, planes, K, max_iter, tdist)
    got = tl.lm_level_from_history(hist, last, T, aff, 0, max_iter)
    ref = tl.lm_level_plain(T, aff, pts, planes, K, max_iter, tdist)
    for a, b in zip(got[:4], ref[:4]):
        assert torch.equal(a, b)
    end = tl.loop_end(hist, last, 0, max_iter)
    assert int(got[4]) == int(ref[4]) == end > 0
    s = tl.history_state(hist, last, 0, 0, max_iter)
    for k in range(end):
        step = tl.lm_step_plain(s, pts, planes, K, max_iter, tdist)
        s = tl.history_state(hist, last, k + 1, 0, max_iter)
        assert (step.it, step.active) == (s.it, s.active)
        for f in ("T", "aff", "lam", "done", "e", "n", "Hm", "g"):
            assert torch.equal(getattr(step, f), getattr(s, f)), (k, f)
        if step.active:
            assert torch.equal(step.T_new, s.T_new)
            assert torch.equal(step.dx, s.dx)
    assert not s.active
    if kind == "lam_explodes":       # a candidate kept stepping past K
        assert int(last.max()) > end


def test_lm_level_cpu_is_plain_and_launches_nothing():
    T, aff, pts, planes, K, max_iter, _ = _case("B5")
    before = tl.lm_level.launches
    got = tl.lm_level(T, aff, pts, planes, K, max_iter)
    ref = tl.lm_level_plain(T, aff, pts, planes, K, max_iter)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert tl.lm_level.launches == before
    with pytest.raises(ValueError):
        tl.lm_level(T.to("meta"), aff, pts, planes, K, max_iter)


def test_tdist_lm_level_cpu_is_plain_and_launches_nothing():
    """The RGB-D branch of the tracker (``_lm_level(tdist=True)``) goes
    through ``lm_level``: on the CPU its plain version with the t
    weights, no launch of either kernel; a meta tensor raises."""
    from tandem_tpu_torch.ops.track_reduce import track_reduce
    T, aff, pts, planes, K, max_iter, _ = _case("tdist")
    before = (tl.lm_level.launches, track_reduce.launches)
    got = tct._lm_level(T, aff, pts, planes, K, max_iter, tdist=True)
    ref = tl.lm_level_plain(T, aff, pts, planes, K, max_iter, True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert (tl.lm_level.launches, track_reduce.launches) == before
    huber = tl.lm_level_plain(T, aff, pts, planes, K, max_iter)
    assert not torch.equal(got[2], huber[2])
    with pytest.raises(ValueError):
        tct._lm_level(T.to("meta"), aff, pts, planes, K, max_iter,
                      tdist=True)


def _lm_level_against_jax(B, tdist):
    """JAX ``_lm_level`` fed ``_pack_level``'s table of the same planes."""
    T, aff, pts, planes, K = _track_case(CPU, 2000, B, H, W, seed=B)
    max_iter = 50
    got = tl.lm_level_plain(T, aff, pts, planes, K, max_iter, tdist)
    packed = jct._pack_level(*(jnp.asarray(p.numpy()) for p in planes))
    data = (tuple(jnp.asarray(p.numpy()) for p in pts), packed, H, W, K)
    ref = jct._lm_level(jnp.asarray(T.numpy()), jnp.asarray(aff.numpy()),
                        data, max_iter, tdist=tdist)
    Tj, affj, ej, nj = (np.asarray(x) for x in ref)
    assert np.abs(got[0].numpy() - Tj).max() <= 1e-4
    assert np.abs(got[1].numpy() - affj).max() <= 1e-4
    np.testing.assert_array_equal(got[3].numpy(), nj)
    np.testing.assert_allclose(got[2].numpy(), ej, rtol=1e-3)


@pytest.mark.parametrize("B", [1, 5, 15])
def test_lm_level_plain_matches_jax(B):
    _lm_level_against_jax(B, False)


@pytest.mark.parametrize("B", [1, 5, 15])
def test_tdist_lm_level_plain_matches_jax(B):
    """The Student-t branch (``_lm_level(..., tdist=True)``): the same
    tolerances; the t weights' scale is a fixed point of sums taken in
    another order on each side, which moves it by rounding only."""
    _lm_level_against_jax(B, True)
