"""The coarse tracker's LM iteration on one pyramid level, on the card.

Port of ``_lm_level`` (``tandem_tpu/tracking/coarse_tracker.py:382``) with
its Huber ``_energy_and_system`` (:348). The JAX package runs a level's
``lax.while_loop`` inside one jitted program; here the loop's body is one
step on a state that lives on the card:

- ``lm_step_plain`` is the body as plain PyTorch: judge the proposal
  (accept, convergence, damping, the selects of T, aff, e, n, H and g),
  ``it += 1``, ``active = it < max_iter and any(~done & (lam < 1e4))``,
  and, if still active, propose the next step (damped 8x8 Gauss-Jordan
  solve, SE(3) update). Once ``active`` is false the step changes nothing,
  so ``max_iter`` steps equal the ``while_loop``.
- ``lm_level_plain`` is the whole level: the first evaluation, the first
  proposal, ``max_iter`` steps and the ``n0 >= 32`` rule. It is the CPU
  path and the card's yardstick.
- ``lm_level`` runs the level with the hand-written CUDA kernel
  ``csrc/track_lm.cu`` for CUDA tensors: each step is two launches (K6's
  partial pass, then one block that sums the partials and runs the step
  for every candidate), with no host sync inside the level except one
  read of ``active`` every ``CHECK_EVERY`` steps. CPU tensors go to
  ``lm_level_plain``; a CUDA tensor never reaches it (there is no
  fallback: the kernel runs or the call raises).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.se3 import se3_exp
from .linalg import solve_gauss_jordan_batched
from .track_reduce import (CUTOFF_TH, HUBER_TH, N_ACC, POINTS_PER_BLOCK,
                           check_inputs, track_reduce_plain)

LAM0 = 0.01                 # the LM damping a level starts from
LAM_MAX = 1e4               # DSO also stops when the damping explodes
MIN_TERMS = 32.0            # fewer residuals cannot constrain 8 DoF
MAX_CANDIDATES = 32         # csrc/track_lm.cu kMaxB: one warp a candidate
# Steps launched between two reads of ``active``. A read waits for the
# card to finish the queued steps and leaves it idle while the host works
# on (~0.1 ms on the H100); a step launched after the level has converged
# is a pair of no-op launches (~5 us). 16 won 3 of the 4 cases of
# chip_smoke.py's sweep over 1, 2, 4, 8, 16 and never, measured on one H100 (PERF.md).
CHECK_EVERY = 16


class LMState(NamedTuple):
    """One level's LM state for B candidates (the ``while_loop`` carry plus
    the proposal it evaluates next)."""
    T: torch.Tensor          # (B, 4, 4) accepted poses
    aff: torch.Tensor        # (B, 2) accepted affine (a, b)
    lam: torch.Tensor        # (B,) damping
    done: torch.Tensor       # (B,) bool, converged
    e: torch.Tensor          # (B,) energy at T
    n: torch.Tensor          # (B,) usable residuals at T
    Hm: torch.Tensor         # (B, 8, 8) normal equations at T
    g: torch.Tensor          # (B, 8)
    dx: torch.Tensor         # (B, 8) the proposed step
    T_new: torch.Tensor      # (B, 4, 4) the proposal se3_exp(dx[:6]) @ T
    aff_new: torch.Tensor    # (B, 2) aff + dx[6:]
    it: int                  # steps taken
    active: bool             # it < max_iter and any(~done & (lam < 1e4))


def _bwhere(cond, a, b):
    """torch.where with a (B,)-shaped condition broadcast over trailing
    dims."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.dim() - 1)), a, b)


def _is_active(it: int, done, lam, max_iter: int) -> bool:
    return it < max_iter and bool((~done & (lam < LAM_MAX)).any())


def _propose(s: LMState) -> LMState:
    """Solve (H + lam diag(H) + 1e-5 I) dx = -g and update the pose."""
    eye = torch.eye(8, dtype=s.Hm.dtype, device=s.Hm.device)
    diag = torch.diagonal(s.Hm, dim1=-2, dim2=-1)
    Hl = s.Hm + s.lam[:, None, None] * (diag[:, :, None] * eye) + 1e-5 * eye
    dx = -solve_gauss_jordan_batched(Hl, s.g, 8)
    return s._replace(dx=dx, T_new=se3_exp(dx[:, :6]) @ s.T,
                      aff_new=s.aff + dx[:, 6:])


def lm_init_plain(T, aff, pts, planes, Klvl, max_iter: int,
                  energy=track_reduce_plain) -> LMState:
    """The level's first evaluation at (T, aff) and its first proposal."""
    e, n, Hm, g = energy(T, aff, pts, planes, Klvl)
    B = T.shape[0]
    lam = torch.full((B,), LAM0, dtype=T.dtype, device=T.device)
    done = torch.zeros(B, dtype=torch.bool, device=T.device)
    s = LMState(T, aff, lam, done, e, n, Hm, g, torch.zeros_like(g), T, aff,
                0, _is_active(0, done, lam, max_iter))
    return _propose(s) if s.active else s


def lm_step_plain(s: LMState, pts, planes, Klvl, max_iter: int,
                  energy=track_reduce_plain) -> LMState:
    """One body of the level's ``while_loop``; a no-op once inactive.

    :param energy: ``(T, aff, pts, planes, Klvl) -> (e, n, Hm, g)``; K6's
        plain version (the Huber branch) unless the caller passes another
        weighting.
    """
    if not s.active:
        return s
    e_new, n_new, H_new, g_new = energy(s.T_new, s.aff_new, pts, planes,
                                        Klvl)
    e_old_n = s.e / torch.clamp(s.n, min=1.0)
    e_new_n = e_new / torch.clamp(n_new, min=1.0)
    accept = (e_new_n < e_old_n) & ~s.done
    # Converged: a tiny step, or an accepted step that barely improved
    small = ((s.dx.abs().amax(-1) < 1e-5)
             | (accept & (e_old_n - e_new_n
                          < 1e-4 * torch.clamp(e_old_n, min=1e-6))))
    lam = torch.where(s.done, s.lam, torch.where(accept, s.lam * 0.5,
                                                 s.lam * 4.0))
    done = s.done | small
    it = s.it + 1
    s = s._replace(T=_bwhere(accept, s.T_new, s.T),
                   aff=_bwhere(accept, s.aff_new, s.aff), lam=lam, done=done,
                   e=torch.where(accept, e_new, s.e),
                   n=torch.where(accept, n_new, s.n),
                   Hm=_bwhere(accept, H_new, s.Hm),
                   g=_bwhere(accept, g_new, s.g), it=it,
                   active=_is_active(it, done, lam, max_iter))
    return _propose(s) if s.active else s


def lm_level_plain(T, aff, pts, planes, Klvl, max_iter: int,
                   energy=track_reduce_plain):
    """A whole level: (T, aff, e, n, it) with it a 0-d int64 tensor. A
    candidate whose level had fewer than 32 usable residuals at the start
    keeps its incoming estimate (sparse maps can starve coarse levels)."""
    s = lm_init_plain(T, aff, pts, planes, Klvl, max_iter, energy)
    enough = s.n >= MIN_TERMS
    for _ in range(max_iter):
        s = lm_step_plain(s, pts, planes, Klvl, max_iter, energy)
    return (_bwhere(enough, s.T, T), _bwhere(enough, s.aff, aff), s.e, s.n,
            torch.tensor(s.it, device=T.device))


# --- the card ----------------------------------------------------------------

# The device state: one f32 buffer, each field a (B, ...) block in this
# order (csrc/track_lm.cu LmState), then ``it`` and ``active``.
_FIELDS = (("T", (4, 4)), ("aff", (2,)), ("T_new", (4, 4)),
           ("aff_new", (2,)), ("dx", (8,)), ("Hm", (8, 8)), ("g", (8,)),
           ("lam", ()), ("done", ()), ("e", ()), ("n", ()), ("n0", ()))
_PER_CANDIDATE = sum(int(torch.Size(s).numel()) for _, s in _FIELDS)


def state_views(buf, B: int) -> dict:
    """The fields of a device state buffer as (B, ...) views, plus the 0-d
    views ``it`` and ``active`` (floats)."""
    out, off = {}, 0
    for name, shape in _FIELDS:
        size = B * int(torch.Size(shape).numel())
        out[name] = buf[off:off + size].view((B,) + shape)
        off += size
    out["it"], out["active"] = buf[off], buf[off + 1]
    return out


def new_state(B: int, device) -> torch.Tensor:
    """An uninitialised device state for B candidates (the kernel's first
    launch of a level fills it)."""
    return torch.empty(B * _PER_CANDIDATE + 2, dtype=torch.float32,
                       device=device)


def pack_state(s: LMState) -> torch.Tensor:
    """A plain state as a device state buffer (f32, on the state's
    device); n0 is taken as n."""
    B = s.T.shape[0]
    buf = new_state(B, s.T.device)
    v = state_views(buf, B)
    for name, _ in _FIELDS:
        v[name].copy_(getattr(s, "n" if name == "n0" else name))
    v["it"].fill_(s.it)
    v["active"].fill_(float(s.active))
    return buf


def unpack_state(buf, B: int) -> LMState:
    """A device state buffer as a plain state (reads it and active)."""
    v = state_views(buf, B)
    return LMState(**{f: v[f].clone() for f in LMState._fields
                      if f not in ("done", "it", "active")},
                   done=v["done"] != 0, it=int(v["it"]),
                   active=bool(v["active"] != 0))


def lm_steps(state, T, aff, pts, planes, Klvl, max_iter: int, n_steps: int,
             init: bool = False) -> None:
    """Launch ``n_steps`` LM steps on a device state, after the level's
    first evaluation and proposal from (T, aff) when ``init``; no sync.
    Each step (and the init) is one launch of the kernel pair."""
    check_inputs("lm_steps", T, aff, pts, planes)
    B, N = T.shape[0], pts[0].shape[0]
    if not 0 < B <= MAX_CANDIDATES:
        raise ValueError(f"lm_steps: 1 to {MAX_CANDIDATES} candidates, "
                         f"got {B}")
    if (state.dtype != torch.float32 or state.device != T.device
            or tuple(state.shape) != (B * _PER_CANDIDATE + 2,)):
        raise ValueError("lm_steps: state must be new_state(B, T.device)")
    from ._build import launch

    H, W = planes[0].shape
    nblk = max(-(-N // POINTS_PER_BLOCK), 1)
    partial = torch.empty((B, nblk, N_ACC), dtype=torch.float32,
                          device=T.device)
    launch("tandem_track_lm", T.device,
           *(p.data_ptr() for p in pts), T.data_ptr(), aff.data_ptr(),
           *(p.data_ptr() for p in planes), N, B, H, W,
           *(float(k) for k in Klvl), CUTOFF_TH, HUBER_TH,
           partial.data_ptr(), nblk, state.data_ptr(), max_iter, int(init),
           n_steps)
    lm_level.launches += int(init) + n_steps


def lm_level(T, aff, pts, planes, Klvl, max_iter: int,
             check_every: int = CHECK_EVERY):
    """One level's LM on the card (CUDA tensors) or its plain version (CPU
    tensors).

    :param T: (B, 4, 4) f32 candidate poses; aff: (B, 2) f32
    :param pts: (pu, pv, pid, pcolor) (N,) f32 and pvalid (N,) bool
    :param planes: (img, gx, gy) (H, W) f32 of the new frame's level
    :param Klvl: (fx, fy, cx, cy) floats
    :param check_every: steps between reads of ``active`` (0: never read,
        launch all ``max_iter`` steps)
    :return: T (B, 4, 4), aff (B, 2), e (B,), n (B,) and the step count as
        a 0-d tensor, all on T's device
    """
    if T.device.type == "cpu":
        return lm_level_plain(T, aff, pts, planes, Klvl, max_iter)
    if T.device.type != "cuda":
        raise ValueError(f"lm_level: unsupported device {T.device}")
    B = T.shape[0]
    state = new_state(B, T.device)
    chunk = check_every if check_every > 0 else max_iter
    steps = min(chunk, max_iter)
    lm_steps(state, T, aff, pts, planes, Klvl, max_iter, steps, init=True)
    v = state_views(state, B)
    while steps < max_iter and bool(v["active"] != 0):
        more = min(chunk, max_iter - steps)
        lm_steps(state, T, aff, pts, planes, Klvl, max_iter, more)
        steps += more
    enough = v["n0"] >= MIN_TERMS
    return (_bwhere(enough, v["T"], T), _bwhere(enough, v["aff"], aff),
            v["e"], v["n"], v["it"])


lm_level.launches = 0
