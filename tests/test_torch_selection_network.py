"""The edge filter kernel's per-pixel selection network
(``tandem_tpu_torch/ops/selection_network.py``, generated into
``csrc/edge_select.cuh``), checked on the CPU where the kernel cannot run:
it selects rank 13 of 24 for every 0-1 input (so, by the 0-1 principle, for
every input), it equals the sort on floats with ties, and run on a depth
map's window differences it equals ``edge_kth_plain`` bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tandem_tpu_torch.ops import selection_network as sn
from tandem_tpu_torch.ops.edge_kth import WINDOW, edge_kth_plain


def test_header_is_generated_from_the_network():
    assert sn.HEADER.read_text() == sn.header()


def test_network_size():
    """94 comparators, 165 min/max: the count chip_smoke.py's bound uses."""
    steps = sn.selection_steps()
    assert (len(steps), sn.min_max_count(steps)) == (94, 165)
    assert all(s.lo < s.hi < sn.N_INPUTS for s in steps)


def test_pairwise_network_sorts():
    rng = np.random.RandomState(0)
    x = rng.rand(500, sn.N_WIRES)
    w = [x[:, i].copy() for i in range(sn.N_WIRES)]
    for lo, hi in sn.pairwise_network(sn.N_WIRES):
        w[lo], w[hi] = np.minimum(w[lo], w[hi]), np.maximum(w[lo], w[hi])
    np.testing.assert_array_equal(np.stack(w, 1), np.sort(x, 1))


def test_selects_rank_13_for_every_0_1_input():
    """All 2^24 inputs of zeros and ones, a million at a time: the output
    is 1 exactly when at least 11 inputs are 1."""
    steps = sn.selection_steps()
    chunk = 1 << 20
    for base in range(0, 1 << sn.N_INPUTS, chunk):
        idx = np.arange(base, base + chunk, dtype=np.uint32)
        wires = [((idx >> i) & 1).astype(np.uint8)
                 for i in range(sn.N_INPUTS)]
        ones = np.sum(wires, axis=0)
        got = sn.run_steps(steps, wires, np.minimum, np.maximum)
        np.testing.assert_array_equal(
            got, (ones >= sn.N_INPUTS - sn.RANK).astype(np.uint8))


@pytest.mark.parametrize("levels", [3, 100, None])
def test_selects_the_sorted_value_with_ties(levels):
    rng = np.random.RandomState(1)
    x = rng.rand(20000, sn.N_INPUTS).astype(np.float32)
    if levels:
        x = np.round(x * levels).astype(np.float32)
    got = sn.run_steps(sn.selection_steps(), [x[:, i] for i in
                                              range(sn.N_INPUTS)],
                       np.minimum, np.maximum)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.sort(x, 1)[:, sn.RANK].view(np.uint32))


@pytest.mark.parametrize("kind", ["random", "tied", "border"])
def test_network_on_window_differences_equals_edge_kth_plain(kind):
    """The kernel's algorithm in torch ops: the 24 neighbours'
    |differences| of each pixel over the zero-padded 5x5 window, through
    the network, equal K1's plain version."""
    rng = np.random.RandomState(2)
    shape = (2, 29, 37)
    if kind == "random":
        d = rng.rand(*shape) * 3
    elif kind == "tied":
        d = np.round(rng.rand(*shape) * 4) / 2
    else:
        d = np.full(shape, 2.0)
        d[..., :5] = 0.0
    depth = torch.from_numpy(d.astype(np.float32))
    H, W = shape[1:]
    h = WINDOW // 2
    padded = F.pad(depth, (h, h, h, h))
    taps = [(padded[:, dy:dy + H, dx:dx + W] - depth).abs()
            for dy in range(WINDOW) for dx in range(WINDOW)
            if (dy, dx) != (h, h)]
    got = sn.run_steps(sn.selection_steps(), taps, torch.minimum,
                       torch.maximum)
    assert torch.equal(got, edge_kth_plain(depth))
