"""Tests of the port that need an NVIDIA GPU: its CUDA kernels have no CPU
mode. They skip without a card. This file imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tandem_tpu_torch.models.edge_filter import depth_filter_edges
from tandem_tpu_torch.ops.edge_kth import edge_kth_plain, edge_kth_value

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _depth(kind: str, shape=(2, 61, 83)):
    rng = np.random.RandomState(3)
    if kind == "random":
        return (rng.rand(*shape) * 3).astype(np.float32)
    if kind == "tied":
        return (np.round(rng.rand(*shape) * 4) / 2).astype(np.float32)
    d = np.full(shape, 2.0, np.float32)
    d[..., :5] = 0.0
    return d


@pytest.mark.parametrize("kind", ["random", "tied", "border"])
def test_edge_kth_kernel_equals_plain(dev, kind):
    """Odd sizes exercise the ragged tile edges; ties must select the same
    value as the sort."""
    depth = torch.from_numpy(_depth(kind)).to(dev)
    before = edge_kth_value.launches
    out = edge_kth_value(depth)
    torch.cuda.synchronize()
    assert edge_kth_value.launches == before + 1
    assert torch.equal(out, edge_kth_plain(depth))


def test_edge_kth_kernel_rejects_bad_input(dev):
    with pytest.raises(ValueError):
        edge_kth_value(torch.zeros((1, 8, 8), dtype=torch.float64,
                                   device=dev))
    with pytest.raises(ValueError):
        edge_kth_value(torch.zeros((1, 8, 16), device=dev)[..., ::2])


def test_depth_filter_edges_card_equals_cpu(dev):
    depth = torch.from_numpy(_depth("random"))
    discard = torch.tensor([10.0, 25.0])
    fd_c, m_c = depth_filter_edges(depth, discard)
    fd_g, m_g = depth_filter_edges(depth.to(dev), discard)
    assert torch.equal(m_g.cpu(), m_c)
    assert torch.equal(fd_g.cpu(), fd_c)
