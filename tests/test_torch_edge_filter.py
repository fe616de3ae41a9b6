"""Kernel K1 (edge filter k-th value) and depth_filter_edges: the PyTorch
port against the JAX package on the same seeded inputs.

On the CPU the port's wrapper runs ``edge_kth_plain``; the JAX side runs
the Pallas kernel in interpret mode (as tests/test_pallas.py does) and its
XLA twin. Every comparison is exact: the k-th value is a selection of one
of 25 identically computed f32 differences, so any mismatch is a bug.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tandem_tpu.models.edge_filter import depth_filter_edges as jax_filter
from tandem_tpu.ops.pallas_kernels import (edge_kth_value_pallas,
                                           edge_kth_value_xla)
from tandem_tpu_torch.models.edge_filter import depth_filter_edges
from tandem_tpu_torch.ops.edge_kth import edge_kth_plain, edge_kth_value


def _depth_case(kind: str, seed: int = 7):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return (rng.rand(2, 64, 96) * 3).astype(np.float32)
    if kind == "tied":
        # Quantised depths: most windows hold many equal differences.
        return (np.round(rng.rand(2, 64, 96) * 4) / 2).astype(np.float32)
    # Border: constant map with an empty (zero-depth) band and a step, so
    # the zero padding, zero pixels and ties all meet at the image edge.
    d = np.full((2, 64, 96), 2.0, np.float32)
    d[:, :, :5] = 0.0
    d[1, 40:] = 3.5
    return d


@pytest.mark.parametrize("kind", ["random", "tied", "border"])
def test_edge_kth_plain_matches_jax(kind):
    depth = _depth_case(kind)
    ours = edge_kth_plain(torch.from_numpy(depth)).numpy()
    for b in range(depth.shape[0]):
        pallas = np.asarray(edge_kth_value_pallas(
            jnp.asarray(depth[b]), block_rows=32, interpret=True))
        xla = np.asarray(edge_kth_value_xla(jnp.asarray(depth[b])))
        np.testing.assert_array_equal(ours[b], pallas)
        np.testing.assert_array_equal(ours[b], xla)


def test_edge_kth_value_cpu_uses_plain():
    depth = torch.from_numpy(_depth_case("random"))
    edge_kth_value.launches = 0
    np.testing.assert_array_equal(edge_kth_value(depth).numpy(),
                                  edge_kth_plain(depth).numpy())
    assert edge_kth_value.launches == 0  # the count is of kernel launches


def test_edge_kth_value_rejects_other_devices():
    with pytest.raises(ValueError):
        edge_kth_value(torch.zeros((1, 8, 8), device="meta"))


@pytest.mark.parametrize("kind", ["random", "tied", "border"])
def test_depth_filter_edges_matches_jax(kind):
    depth = _depth_case(kind)
    discard = np.array([10.0, 25.0], np.float32)
    fd_j, mask_j = jax_filter(jnp.asarray(depth), jnp.asarray(discard))
    fd_t, mask_t = depth_filter_edges(torch.from_numpy(depth),
                                      torch.from_numpy(discard))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(fd_t.numpy(), np.asarray(fd_j))
