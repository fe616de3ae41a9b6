"""Kernel K1 (edge filter k-th value), the edge filter op and
depth_filter_edges: the PyTorch port against the JAX package on the same
seeded inputs.

On the CPU the port's wrappers run their plain versions (``edge_kth_plain``,
``radix_select_plain`` and the wheres); the JAX side runs the Pallas kernel
in interpret mode (as tests/test_pallas.py does) and its XLA twin. Every
comparison is exact: the k-th value is a selection of one of 25
identically computed f32 differences, and the threshold a selection of one
of the edge values, so any mismatch is a bug.

The threshold is held against the exact ``np.sort(x)[k]``, not against the
JAX package's: its histogram bisection (``_kth_value``) can end a few ulps
above the k-th value on heavy-tailed images (the "heavy" cases below). The
masks and outputs still equal the JAX package's there, because no edge
value falls into that gap.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tandem_tpu.models.edge_filter import _kth_value
from tandem_tpu.models.edge_filter import depth_filter_edges as jax_filter
from tandem_tpu.ops.pallas_kernels import (edge_kth_value_pallas,
                                           edge_kth_value_xla)
from tandem_tpu_torch.models.edge_filter import (depth_filter_edges,
                                                 filter_edges)
from tandem_tpu_torch.ops import edge_kth as ek
from tandem_tpu_torch.ops.edge_kth import (discard_ranks, edge_filter,
                                           edge_filter_plain, edge_kth_plain,
                                           edge_kth_value, radix_select_plain)

KINDS = ["random", "tied", "border", "heavy"]


def _depth_case(kind: str, seed: int = 7):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return (rng.rand(2, 64, 96) * 3).astype(np.float32)
    if kind == "tied":
        # Quantised depths: most windows hold many equal differences.
        return (np.round(rng.rand(2, 64, 96) * 4) / 2).astype(np.float32)
    if kind == "heavy":
        # Cauchy magnitudes: the JAX bisection's threshold of image 0 at
        # the 10% discard ends above the exact k-th value (seed 0).
        rng = np.random.RandomState(0)
        return (np.clip(np.abs(rng.standard_cauchy((2, 64, 96))), 0, 1e6)
                * 1e-3).astype(np.float32)
    # Border: constant map with an empty (zero-depth) band and a step, so
    # the zero padding, zero pixels and ties all meet at the image edge.
    d = np.full((2, 64, 96), 2.0, np.float32)
    d[:, :, :5] = 0.0
    d[1, 40:] = 3.5
    return d


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


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


@pytest.mark.parametrize("kind", KINDS)
def test_depth_filter_edges_matches_jax(kind):
    depth = _depth_case(kind)
    discard = np.array([10.0, 25.0], np.float32)
    fd_j, mask_j = jax_filter(jnp.asarray(depth), jnp.asarray(discard))
    fd_t, mask_t = depth_filter_edges(torch.from_numpy(depth),
                                      torch.from_numpy(discard))
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(fd_t.numpy(), np.asarray(fd_j))


@pytest.mark.parametrize("discard", [(10.0, 25.0), (25.0, 10.0)])
@pytest.mark.parametrize("kind", KINDS)
def test_edge_filter_matches_jax(kind, discard):
    """The op's depth, mask and confidence equal the JAX package's
    depth_filter_edges and the JAX runner's jnp.where(mask, 0.0, conf);
    its threshold is the exact k-th edge value."""
    depth = _depth_case(kind)
    conf = np.random.RandomState(11).rand(*depth.shape).astype(np.float32)
    disc = np.array(discard, np.float32)
    fd_j, mask_j = jax_filter(jnp.asarray(depth), jnp.asarray(disc))
    fc_j = jnp.where(mask_j, 0.0, jnp.asarray(conf))
    edge_filter.calls = 0
    out = filter_edges(torch.from_numpy(depth), torch.from_numpy(disc),
                       torch.from_numpy(conf))
    assert edge_filter.calls == 0           # the CPU path runs no kernel
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(out.depth.numpy(), np.asarray(fd_j))
    np.testing.assert_array_equal(out.conf.numpy(), np.asarray(fc_j))
    edge = edge_kth_plain(torch.from_numpy(depth)).numpy().reshape(2, -1)
    ks = discard_ranks(torch.from_numpy(disc), edge.shape[1])
    exact = [np.sort(edge[b])[k] for b, k in enumerate(ks)]
    np.testing.assert_array_equal(_bits(out.threshold.numpy()), _bits(exact))


def test_heavy_case_is_one_where_the_jax_threshold_is_inexact():
    """The precondition of the "heavy" cases: there the JAX bisection's
    threshold is not the k-th value, so they test the mask, not it."""
    edge = edge_kth_plain(torch.from_numpy(_depth_case("heavy")))
    edge = edge.numpy().reshape(2, -1)
    ks = discard_ranks(torch.tensor([10.0, 25.0]), edge.shape[1])
    jax_thres = np.asarray(_kth_value(jnp.asarray(edge),
                                      jnp.asarray(ks, jnp.int32)))
    assert jax_thres[0] > np.sort(edge[0])[ks[0]]


def _select_case(kind: str):
    """(values (B, N) float32 >= 0, ranks) for the radix select."""
    rng = np.random.RandomState(5)
    n = 4099                               # not a multiple of any bin count
    if kind == "uniform":
        x = rng.rand(3, n)
    elif kind == "ties":
        x = np.round(rng.rand(3, n) * 8) / 4
    elif kind == "all_equal":
        x = np.full((3, n), 0.75)
    elif kind == "zeros":
        x = rng.rand(3, n) * (rng.rand(3, n) < 0.5)
        x[2] = 0.0
    elif kind == "wide_range":             # every exponent, denormals, inf
        x = np.abs(rng.standard_normal((3, n))) * 2.0 ** rng.randint(
            -149, 127, (3, n))
        x[0, :5] = [0.0, np.inf, 1e-45, 3e38, 1.0]
    else:                                  # "heavy": clipped Cauchy
        x = np.clip(np.abs(rng.standard_cauchy((3, n))), 0, 1e6) * 1e-3
    x = x.astype(np.float32)
    return x, [0, n - 1, int(np.float32(n * 0.9))]


@pytest.mark.parametrize("kind", ["uniform", "ties", "all_equal", "zeros",
                                  "wide_range", "heavy"])
def test_radix_select_plain_is_exact(kind):
    """Equal to np.sort(x)[k] and torch.kthvalue bit for bit, at k = 0,
    k = N - 1 and the 10% discard."""
    x, ks = _select_case(kind)
    got = radix_select_plain(torch.from_numpy(x), ks).numpy()
    exact = [np.sort(x[b])[k] for b, k in enumerate(ks)]
    kth = [torch.kthvalue(torch.from_numpy(x[b]), k + 1).values.item()
           for b, k in enumerate(ks)]
    np.testing.assert_array_equal(_bits(got), _bits(exact))
    np.testing.assert_array_equal(_bits(got), _bits(kth))


def test_radix_select_plain_heavy_edge_image_against_jax():
    """A heavy-tailed 64x96 edge image (seeded Cauchy magnitudes, k = 90%)
    on which the JAX bisection ends above the exact k-th value: the radix
    select is exact, and its mask equals the JAX package's."""
    x = (np.clip(np.abs(np.random.RandomState(0).standard_cauchy(
        (1, 64 * 96))), 0, 1e6) * 1e-3).astype(np.float32)
    k = int(np.float32(x.shape[1] * 0.9))
    jax_thres = np.asarray(_kth_value(jnp.asarray(x),
                                      jnp.asarray([k], jnp.int32)))
    exact = np.sort(x[0])[k]
    assert jax_thres[0] > exact            # the case is what it claims
    got = radix_select_plain(torch.from_numpy(x), [k]).numpy()
    np.testing.assert_array_equal(_bits(got), _bits([exact]))
    np.testing.assert_array_equal(x > got[:, None], x > jax_thres[:, None])


def test_edge_filter_plain_without_confidence():
    depth = torch.from_numpy(_depth_case("random"))
    out = edge_filter(depth, [100, 6000])
    assert out.conf is None
    ref = edge_filter_plain(depth, [100, 6000], depth.clone())
    for a, b in ((out.depth, ref.depth), (out.mask, ref.mask),
                 (out.threshold, ref.threshold), (ref.conf, ref.depth)):
        assert torch.equal(a, b)


def test_edge_filter_rejects_bad_arguments():
    depth = torch.zeros((2, 8, 8))
    for ranks in ([0], [0, 64], [-1, 0]):
        with pytest.raises(ValueError):
            edge_filter(depth, ranks)
    with pytest.raises(ValueError):
        edge_filter(depth, [0, 0], torch.zeros((2, 8, 9)))
    with pytest.raises(ValueError):
        edge_filter(depth.double(), [0, 0])


@pytest.mark.parametrize("with_conf", [True, False])
def test_filter_call_outputs_own_their_memory(with_conf):
    """The card's call allocates each output apart from the scratch (the
    histograms and state, then the edge values), and its argument block
    points at them in csrc/edge_kth.cu FilterArgs order."""
    depth = torch.zeros((3, 7, 11))
    conf = torch.zeros((3, 7, 11)) if with_conf else None
    args, out, scratch = ek._filter_call(depth, [0, 5, 76], conf)
    fields = ek._FILTER_ARGS.unpack(args)
    for t in (out.depth, out.conf, out.mask, out.threshold):
        if t is not None:
            assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    assert out.depth.shape == out.mask.shape == (3, 7, 11)
    assert out.threshold.shape == (3,) and out.mask.dtype == torch.bool
    assert scratch.numel() == 3 * (ek._SCRATCH_WORDS + 7 * 11)
    assert ek._SCRATCH_WORDS % 32 == 0       # edge values on a 128-byte line
    assert fields[:11] == (
        depth.data_ptr(), conf.data_ptr() if with_conf else 0,
        out.depth.data_ptr(), out.conf.data_ptr() if with_conf else 0,
        out.mask.data_ptr(), out.threshold.data_ptr(), scratch.data_ptr(),
        3, 7, 11, 0)
    assert fields[11:14] == (0, 5, 76) and not any(fields[14:])
