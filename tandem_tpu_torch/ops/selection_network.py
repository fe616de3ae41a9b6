"""The edge filter's per-pixel selection as a pruned sorting network.

K1 needs, per pixel, the 15th smallest of 25 differences |d(y+dy, x+dx) -
d(y, x)|. The centre's own difference is always +0, the least of all, so
the answer is the 14th smallest (0-indexed rank 13) of the other 24. This
module builds Parberry's pairwise sorting network for 32 inputs, holds
wires 24-31 at +inf (their comparators fall away) and prunes it backwards
from output wire 13: a comparator whose max (or min) output no later step
needs keeps only its min (or max). What is left is 94 comparators, 165
min/max, where forgetful selection (14 extractions of the least of 12)
needs 318 and Batcher's odd-even merge sort pruned the same way 187.

``csrc/edge_select.cuh`` is generated from it; regenerate after a change:

    python -m tandem_tpu_torch.ops.selection_network
"""

from __future__ import annotations

from pathlib import Path
from typing import List, NamedTuple

N_WIRES = 32
N_INPUTS = 24
RANK = 13
HEADER = Path(__file__).resolve().parent.parent / "csrc" / "edge_select.cuh"


class Step(NamedTuple):
    lo: int          # wire that receives the min
    hi: int          # wire that receives the max
    keep_min: bool   # the min is needed later
    keep_max: bool   # the max is needed later


def pairwise_network(n: int) -> List[tuple]:
    """Parberry's pairwise sorting network for n = 2^m inputs: comparators
    (lo, hi) in order; each leaves the min on lo and the max on hi."""
    pairs = []
    a = 1
    while a < n:
        b, c = a, 0
        while b < n:
            pairs.append((b - a, b))
            b, c = b + 1, (c + 1) % a
            if c == 0:
                b += a
        a *= 2
    a, e = a // 4, 1
    while a > 0:
        d = e
        while d > 0:
            b, c = (d + 1) * a, 0
            while b < n:
                pairs.append((b - d * a, b))
                b, c = b + 1, (c + 1) % a
                if c == 0:
                    b += a
            d //= 2
        a, e = a // 2, 2 * e + 1
    return pairs


def selection_steps(n_wires: int = N_WIRES, n_inputs: int = N_INPUTS,
                    rank: int = RANK) -> List[Step]:
    """The pairwise network with wires >= n_inputs held at +inf, pruned to
    output wire ``rank``: the steps that select the rank-th smallest of the
    values on wires 0..n_inputs-1."""
    live = []
    for lo, hi in pairwise_network(n_wires):
        if hi >= n_inputs:          # min(x, +inf) = x: nothing moves
            continue
        live.append((lo, hi))
    need, steps = {rank}, []
    for lo, hi in reversed(live):
        keep_min, keep_max = lo in need, hi in need
        if keep_min or keep_max:
            steps.append(Step(lo, hi, keep_min, keep_max))
            need |= {lo, hi}
    return steps[::-1]


def min_max_count(steps: List[Step]) -> int:
    return sum(s.keep_min + s.keep_max for s in steps)


def run_steps(steps: List[Step], wires: list, minimum, maximum):
    """Apply ``steps`` to ``wires`` (a list of array-likes, one a wire) with
    the given elementwise min and max; return the selected wire."""
    w = list(wires)
    for s in steps:
        a, b = w[s.lo], w[s.hi]
        if s.keep_min:
            w[s.lo] = minimum(a, b)
        if s.keep_max:
            w[s.hi] = maximum(a, b)
    return w[RANK]


def header() -> str:
    steps = selection_steps()
    lines = [
        "// Generated by python -m tandem_tpu_torch.ops.selection_network;",
        "// do not edit. Parberry's pairwise sorting network for 32 inputs,",
        f"// wires {N_INPUTS}-{N_WIRES - 1} held at +inf, pruned to output "
        f"wire {RANK}: the",
        f"// {RANK}th smallest (0-indexed) of {N_INPUTS} values in "
        f"{len(steps)} comparators,",
        f"// {min_max_count(steps)} fminf/fmaxf. Only fminf/fmaxf move "
        "values, so the result is",
        "// one of the inputs bit for bit, for any ties.",
        "#pragma once",
        "",
        f"__device__ __forceinline__ float select_rank{RANK}_of{N_INPUTS}("
        f"float (&v)[{N_INPUTS}]) {{",
    ]
    for s in steps:
        if s.keep_min and s.keep_max:
            lines.append(f"  {{ const float t = v[{s.lo}]; "
                         f"v[{s.lo}] = fminf(t, v[{s.hi}]); "
                         f"v[{s.hi}] = fmaxf(t, v[{s.hi}]); }}")
        elif s.keep_min:
            lines.append(f"  v[{s.lo}] = fminf(v[{s.lo}], v[{s.hi}]);")
        else:
            lines.append(f"  v[{s.hi}] = fmaxf(v[{s.lo}], v[{s.hi}]);")
    lines += [f"  return v[{RANK}];", "}", ""]
    return "\n".join(lines)


if __name__ == "__main__":
    HEADER.write_text(header())
    steps = selection_steps()
    print(f"{HEADER}: {len(steps)} comparators, {min_max_count(steps)} "
          f"min/max")
