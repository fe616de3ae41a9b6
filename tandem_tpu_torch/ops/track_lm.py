"""The coarse tracker's LM iteration on one pyramid level, on the card.

Port of ``_lm_level`` (``tandem_tpu/tracking/coarse_tracker.py:382``) with
its ``_energy_and_system`` (:348) in either weighting (DSO's Huber + cutoff,
or with ``tdist`` dvo's Student-t weights). The JAX package runs a level's
``lax.while_loop`` inside one jitted program:

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
  ``csrc/track_lm.cu`` for CUDA tensors: one launch a level, no host read
  inside it. CPU tensors go to ``lm_level_plain``; a CUDA tensor never
  reaches it (there is no fallback: the kernel runs or the call raises).

The kernel runs the loop for each candidate on its own and resolves the
loop's condition afterwards, from a history of every candidate's state
after every step (``RECORD_FIELDS``): a candidate's state after k steps
does not depend on the others, a done candidate is frozen, and once the
condition is false nothing changes. ``lm_history_plain`` and
``lm_level_from_history`` are that decoupled loop in plain PyTorch (the CPU
tests hold it to ``lm_level_plain`` bit for bit); ``lm_run`` exposes the
kernel's history (and a start from a given state) to the card's checks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.se3 import se3_exp
from .linalg import solve_gauss_jordan_batched
from .track_reduce import (check_inputs, check_plan, level_args,
                           track_reduce_plain)

LAM0 = 0.01                 # the LM damping a level starts from
LAM_MAX = 1e4               # DSO also stops when the damping explodes
MIN_TERMS = 32.0            # fewer residuals cannot constrain 8 DoF
MAX_CANDIDATES = 32         # csrc/track_lm.cu kMaxB


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


def _live(done, lam):
    return ~done & (lam < LAM_MAX)


def _is_active(it: int, done, lam, max_iter: int) -> bool:
    return it < max_iter and bool(_live(done, lam).any())


def _propose(s: LMState) -> LMState:
    """Solve (H + lam diag(H) + 1e-5 I) dx = -g and update the pose."""
    eye = torch.eye(8, dtype=s.Hm.dtype, device=s.Hm.device)
    diag = torch.diagonal(s.Hm, dim1=-2, dim2=-1)
    Hl = s.Hm + s.lam[:, None, None] * (diag[:, :, None] * eye) + 1e-5 * eye
    dx = -solve_gauss_jordan_batched(Hl, s.g, 8)
    return s._replace(dx=dx, T_new=se3_exp(dx[:, :6]) @ s.T,
                      aff_new=s.aff + dx[:, 6:])


def _judge(s: LMState, e_new, n_new, H_new, g_new) -> LMState:
    """The proposal's accept, convergence and damping, given its sums;
    ``it += 1`` (``active`` is left to the caller)."""
    e_old_n = s.e / torch.clamp(s.n, min=1.0)
    e_new_n = e_new / torch.clamp(n_new, min=1.0)
    accept = (e_new_n < e_old_n) & ~s.done
    # Converged: a tiny step, or an accepted step that barely improved
    small = ((s.dx.abs().amax(-1) < 1e-5)
             | (accept & (e_old_n - e_new_n
                          < 1e-4 * torch.clamp(e_old_n, min=1e-6))))
    lam = torch.where(s.done, s.lam, torch.where(accept, s.lam * 0.5,
                                                 s.lam * 4.0))
    return s._replace(T=_bwhere(accept, s.T_new, s.T),
                      aff=_bwhere(accept, s.aff_new, s.aff), lam=lam,
                      done=s.done | small,
                      e=torch.where(accept, e_new, s.e),
                      n=torch.where(accept, n_new, s.n),
                      Hm=_bwhere(accept, H_new, s.Hm),
                      g=_bwhere(accept, g_new, s.g), it=s.it + 1)


def lm_init_plain(T, aff, pts, planes, Klvl, max_iter: int,
                  tdist: bool = False) -> LMState:
    """The level's first evaluation at (T, aff) and its first proposal."""
    e, n, Hm, g = track_reduce_plain(T, aff, pts, planes, Klvl, tdist)
    B = T.shape[0]
    lam = torch.full((B,), LAM0, dtype=T.dtype, device=T.device)
    done = torch.zeros(B, dtype=torch.bool, device=T.device)
    s = LMState(T, aff, lam, done, e, n, Hm, g, torch.zeros_like(g), T, aff,
                0, _is_active(0, done, lam, max_iter))
    return _propose(s) if s.active else s


def lm_step_plain(s: LMState, pts, planes, Klvl, max_iter: int,
                  tdist: bool = False) -> LMState:
    """One body of the level's ``while_loop``; a no-op once inactive."""
    if not s.active:
        return s
    s = _judge(s, *track_reduce_plain(s.T_new, s.aff_new, pts, planes, Klvl,
                                      tdist))
    s = s._replace(active=_is_active(s.it, s.done, s.lam, max_iter))
    return _propose(s) if s.active else s


def lm_level_plain(T, aff, pts, planes, Klvl, max_iter: int,
                   tdist: bool = False):
    """A whole level: (T, aff, e, n, it) with it a 0-d int64 tensor. A
    candidate whose level had fewer than 32 usable residuals at the start
    keeps its incoming estimate (sparse maps can starve coarse levels)."""
    s = lm_init_plain(T, aff, pts, planes, Klvl, max_iter, tdist)
    enough = s.n >= MIN_TERMS
    for _ in range(max_iter):
        s = lm_step_plain(s, pts, planes, Klvl, max_iter, tdist)
    return (_bwhere(enough, s.T, T), _bwhere(enough, s.aff, aff), s.e, s.n,
            torch.tensor(s.it, device=T.device))


# --- the history of the decoupled loop ---------------------------------------

# A candidate's state after a step, as the kernel records it: f32 fields in
# this order (csrc/track_lm.cu LmState), padded to RECORD floats.
RECORD_FIELDS = (("T", (4, 4)), ("aff", (2,)), ("T_new", (4, 4)),
                 ("aff_new", (2,)), ("dx", (8,)), ("Hm", (8, 8)), ("g", (8,)),
                 ("lam", ()), ("done", ()), ("e", ()), ("n", ()), ("n0", ()),
                 ("live", ()))
RECORD = 128


def _offsets() -> dict:
    out, off = {}, 0
    for name, shape in RECORD_FIELDS:
        size = int(torch.Size(shape).numel())
        out[name] = (off, shape)
        off += size
    assert off <= RECORD
    return out


_OFFSETS = _offsets()


def record_view(rec, name: str):
    """Field ``name`` of records ``rec`` (..., RECORD) as a (..., *shape)
    view."""
    off, shape = _OFFSETS[name]
    size = int(torch.Size(shape).numel())
    return rec[..., off:off + size].reshape(rec.shape[:-1] + shape)


def pack_state(s: LMState, n0=None) -> torch.Tensor:
    """A plain state as (B, RECORD) f32 records on its device (n0 = n
    unless given; live from done and lam; the padding 0)."""
    B = s.T.shape[0]
    rec = torch.zeros((B, RECORD), dtype=torch.float32, device=s.T.device)
    fields = {**s._asdict(), "n0": s.n if n0 is None else n0,
              "live": _live(s.done, s.lam)}
    for name, _ in RECORD_FIELDS:
        record_view(rec, name).copy_(fields[name])
    return rec


def unpack_state(rec, it: int, max_iter: int) -> LMState:
    """(B, RECORD) records after ``it`` steps as a plain state."""
    f = {name: record_view(rec, name).clone() for name, _ in RECORD_FIELDS}
    done = f["done"] != 0
    return LMState(**{k: f[k] for k in LMState._fields
                      if k not in ("done", "it", "active")},
                   done=done, it=it,
                   active=it < max_iter and bool((f["live"] != 0).any()))


def history_state(hist, last, k: int, it0: int, max_iter: int) -> LMState:
    """The level's state after step k of a history (B, steps + 1, RECORD)
    whose candidate b stopped at step last[b] (frozen after it)."""
    B = hist.shape[0]
    idx = torch.clamp(last.long(), max=k)
    return unpack_state(hist[torch.arange(B, device=hist.device), idx],
                        it0 + k, max_iter)


def loop_end(hist, last, it0: int, max_iter: int) -> int:
    """K: the first step after which the loop's condition is false (no
    candidate live, or it0 + K = max_iter), else the steps recorded."""
    steps = hist.shape[1] - 1
    last = [int(x) for x in last.tolist()]
    live = record_view(hist, "live").tolist()
    for k in range(steps + 1):
        if it0 + k >= max_iter or not any(
                k <= last[b] and live[b][k] != 0 for b in range(len(last))):
            return k
    return steps


def lm_level_from_history(hist, last, T, aff, it0: int, max_iter: int):
    """The level's result from a history (the kernel's tail): candidate b's
    state at min(K, last[b]), the n0 >= 32 rule, it = it0 + K."""
    K = loop_end(hist, last, it0, max_iter)
    s = history_state(hist, last, K, it0, max_iter)
    B = hist.shape[0]
    n0 = record_view(hist[torch.arange(B, device=hist.device),
                          torch.clamp(last.long(), max=K)], "n0")
    enough = n0 >= MIN_TERMS
    return (_bwhere(enough, s.T, T), _bwhere(enough, s.aff, aff), s.e, s.n,
            torch.tensor(it0 + K, device=T.device))


def lm_history_plain(T, aff, pts, planes, Klvl, max_iter: int,
                     tdist: bool = False):
    """The kernel's decoupled loop in plain PyTorch: every candidate, from
    its first evaluation, steps until it is done or max_iter steps are taken
    (proposing after every step but the last, live or not), whatever the
    others do, and its state after every step is recorded. The candidates
    step in lockstep, so that each step runs the ops of ``lm_step_plain`` at
    the same batch size (PyTorch's CPU einsum rounds a batch of one
    otherwise); a done candidate is frozen, its later evaluations unused.
    Returns the history (B, max_iter + 1, RECORD), zero after a candidate's
    last step, and the last steps (B,)."""
    B = T.shape[0]
    hist = torch.zeros((B, max_iter + 1, RECORD), dtype=torch.float32,
                       device=T.device)
    s = lm_init_plain(T, aff, pts, planes, Klvl, max_iter, tdist)
    n0 = s.n
    hist[:, 0] = pack_state(s, n0)
    last = torch.zeros(B, dtype=torch.int64, device=T.device)
    while s.it < max_iter and not bool(s.done.all()):
        stepping = ~s.done
        s = _judge(s, *track_reduce_plain(s.T_new, s.aff_new, pts, planes,
                                          Klvl, tdist))
        if s.it < max_iter:
            s = _propose(s)
        hist[stepping, s.it] = pack_state(s, n0)[stepping]
        last[stepping] = s.it
    return hist, last


# --- the card ----------------------------------------------------------------

_COUNTERS: dict = {}


def _counter(device, stream: int) -> torch.Tensor:
    """The last-cluster counter of the calls on one stream (0 between
    calls: the kernel's last cluster resets it)."""
    key = (device.index, stream)
    if key not in _COUNTERS:
        _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _COUNTERS[key]


def lm_run(T, aff, pts, planes, Klvl, max_iter: int, tdist: bool = False,
           state=None, it0: int = 0, n_steps: int = None):
    """One launch of the LM kernel: from the level's first evaluation at
    (T, aff), or from ``state`` ((B, RECORD) records after ``it0`` steps),
    at most ``n_steps`` steps (default: up to max_iter). Returns (out,
    hist, last): out the f32 (B * 20 + 1) result (T, aff, e, n, it; see
    ``lm_level``), hist the (B, n_steps + 1, RECORD) history and last the
    (B,) last step of each candidate, all on the card, unsynchronised."""
    check_inputs("lm_level", T, aff, pts, planes)
    B, N = T.shape[0], pts[0].shape[0]
    if not 0 < B <= MAX_CANDIDATES:
        raise ValueError(f"lm_level: 1 to {MAX_CANDIDATES} candidates, "
                         f"got {B}")
    check_plan("lm_level", N, tdist)
    remaining = max(max_iter - it0, 0)
    n_steps = remaining if n_steps is None else min(n_steps, remaining)
    dev = T.device
    if state is not None and (state.dtype != torch.float32
                              or state.device != dev
                              or tuple(state.shape) != (B, RECORD)
                              or not state.is_contiguous()):
        raise ValueError("lm_level: state must be (B, RECORD) f32 records "
                         f"on {dev}")
    from ._build import current_stream, launch

    scratch = torch.empty(B * (n_steps + 1) * RECORD + B, dtype=torch.float32,
                          device=dev)
    hist = scratch[:-B].view(B, n_steps + 1, RECORD)
    out = torch.empty(B * 20 + 1, dtype=torch.float32, device=dev)
    launch("tandem_track_lm", dev, T.data_ptr(), aff.data_ptr(), B,
           *level_args(pts, planes, Klvl, tdist),
           0 if state is None else state.data_ptr(), it0, max_iter, n_steps,
           scratch.data_ptr(), _counter(dev, current_stream(dev)).data_ptr(),
           out.data_ptr())
    lm_level.launches += 1
    return out, hist, scratch[-B:]


def lm_level(T, aff, pts, planes, Klvl, max_iter: int, tdist: bool = False):
    """One level's LM on the card (CUDA tensors: one launch, no host read)
    or its plain version (CPU tensors).

    :param T: (B, 4, 4) f32 candidate poses; aff: (B, 2) f32
    :param pts: (pu, pv, pid, pcolor) (N,) f32 and pvalid (N,) bool
    :param planes: (img, gx, gy) (H, W) f32 of the new frame's level
    :param Klvl: (fx, fy, cx, cy) floats
    :param tdist: the Student-t weighting instead of Huber + cutoff
    :return: T (B, 4, 4), aff (B, 2), e (B,), n (B,) and the step count as
        a 0-d tensor, all on T's device
    """
    if T.device.type == "cpu":
        return lm_level_plain(T, aff, pts, planes, Klvl, max_iter, tdist)
    if T.device.type != "cuda":
        raise ValueError(f"lm_level: unsupported device {T.device}")
    return level_result(lm_run(T, aff, pts, planes, Klvl, max_iter,
                               tdist)[0], T.shape[0])


def level_result(out, B: int):
    """``lm_run``'s out buffer as (T (B, 4, 4), aff (B, 2), e (B,), n (B,),
    it (0-d)) views."""
    return (out[:16 * B].view(B, 4, 4), out[16 * B:18 * B].view(B, 2),
            out[18 * B:19 * B], out[19 * B:20 * B], out[20 * B])


lm_level.launches = 0
