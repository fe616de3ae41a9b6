"""The plane-sweep sample: kernels P5 (bilinear_index), P3 (corner_blend)
and the row gather (P1/P2/P4), pack_corners, grid_sample and the depth
reprojection warp — the PyTorch port against the JAX package on the same
seeded numpy inputs.

On the CPU the port's wrappers run their plain versions. The JAX side runs
the Pallas probe kernels themselves in interpret mode (each probe module is
loaded with its ``pl.pallas_call`` bound to ``interpret=True``; nothing in
the JAX package changes), the probes' own XLA chains, and the JAX sample
functions. Tolerances are stated per test.
"""

import ast
import functools
import importlib.util
import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from tandem_tpu.ops.grid_sample import _pack_corners as j_pack_corners
from tandem_tpu.ops.grid_sample import bilinear_sample_pixel as j_sample
from tandem_tpu.ops.grid_sample import grid_sample_bilinear as j_grid_sample
from tandem_tpu.ops.warp3d import depth_reprojection_warp as j_warp3d
from tandem_tpu_torch.ops.bilinear_index import (bilinear_index,
                                                 bilinear_index_plain)
from tandem_tpu_torch.ops.corner_blend import corner_blend, corner_blend_plain
from tandem_tpu_torch.ops.grid_sample import (bilinear_sample_pixel,
                                              grid_sample_bilinear,
                                              pack_corners)
from tandem_tpu_torch.ops.row_gather import row_gather
from tandem_tpu_torch.ops.warp3d import depth_reprojection_warp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_EPS = 2.0 ** -8   # bf16 unit roundoff (8 significand bits)


def _probe(name: str):
    """Load ``experiments/<name>.py`` as a fresh module whose Pallas calls
    run in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        f"_interp_{name}", os.path.join(REPO, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    return mod


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _within_bf16_ulp(a, b, ulps: int = 1):
    """|a - b| <= ulps bf16 ulps of b (elementwise, in b's binade)."""
    a, b = _np(a), _np(b)
    ulp = np.where(b == 0, 0.0, 2.0 ** (np.floor(np.log2(
        np.maximum(np.abs(b), 1e-38))) - 7))
    assert np.all(np.abs(a - b) <= ulps * ulp), \
        f"max |err| {np.abs(a - b).max()}"


def _probe_positions(H, W, shape, seed):
    """The idxchain probe's distribution (x in [-2, W+1), y in [-2, H+1))
    plus exact pad-edge cells: x0 = -1 and x0 = W - 1, y0 likewise."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2.0, W + 1.0, shape).astype(np.float32)
    y = rng.uniform(-2.0, H + 1.0, shape).astype(np.float32)
    x.reshape(-1)[:64] = rng.uniform(-1.0, 0.0, 64)
    x.reshape(-1)[64:128] = rng.uniform(W - 1.0, W, 64)
    y.reshape(-1)[128:192] = rng.uniform(-1.0, 0.0, 64)
    y.reshape(-1)[192:256] = rng.uniform(H - 1.0, H, 64)
    x.reshape(-1)[256:262] = np.arange(-1, 5)
    return x, y


# --- P5 ----------------------------------------------------------------------

def test_bilinear_index_matches_idxchain_probe():
    """P5 in bf16 against the Pallas kernel ``make_pallas`` (interpret
    mode) and the probe's XLA chains ``chain_float``/``chain_int``, at the
    probe's H, W = 240, 320 and (n, 128) layout. Rows exact; weights within
    1 bf16 ulp (measured: exact)."""
    chain = _probe("bench_idxchain")
    x, y = _probe_positions(chain.H, chain.W, (64, 128), seed=0)
    rows, w = bilinear_index(torch.from_numpy(x), torch.from_numpy(y),
                             chain.H, chain.W, dtype=torch.bfloat16)
    refs = [jax.jit(chain.make_pallas(32))(jnp.asarray(x), jnp.asarray(y)),
            jax.jit(chain.chain_float)(jnp.asarray(x), jnp.asarray(y)),
            jax.jit(chain.chain_int)(jnp.asarray(x), jnp.asarray(y))]
    for ref in refs:
        np.testing.assert_array_equal(rows.numpy(), np.asarray(ref[0]))
        for k in range(4):
            _within_bf16_ulp(w[k], ref[1 + k])


def _jax_warp_chain(px, py, keep, H, W, dtype):
    """``tandem_tpu/ops/warp.py:124-140`` and the row fold of ``_plain``
    (:148-152), verbatim: the warp inlines its chain, so it has no callable
    of its own."""
    B = px.shape[0]
    x0 = jnp.floor(px)
    y0 = jnp.floor(py)
    wx1 = px - x0
    wy1 = py - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    inside = ((x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
              & keep)
    ins = inside.astype(jnp.float32)
    w00 = (wx0 * wy0 * ins).astype(dtype)
    w10 = (wx1 * wy0 * ins).astype(dtype)
    w01 = (wx0 * wy1 * ins).astype(dtype)
    w11 = (wx1 * wy1 * ins).astype(dtype)
    xi = jnp.clip(x0, -1, W - 1).astype(jnp.int32) + 1
    yi = jnp.clip(y0, -1, H - 1).astype(jnp.int32) + 1
    offs = (jnp.arange(B, dtype=jnp.int32) * ((H + 1) * (W + 1)))
    rows = yi * (W + 1) + xi + offs.reshape((B,) + (1,) * (px.ndim - 1))
    return rows, (w00, w10, w01, w11)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_index_matches_warp_chain(dtype):
    """P5 with the keep mask and two batches against the warp's own chain:
    exact in f32; rows exact and weights within 1 bf16 ulp in bf16
    (measured: exact)."""
    H, W = 13, 21
    x, y = _probe_positions(H, W, (2, 3, H, W), seed=1)
    keep = np.random.RandomState(2).rand(2, 3, H, W) < 0.8
    rows, w = bilinear_index(torch.from_numpy(x), torch.from_numpy(y), H, W,
                             keep=torch.from_numpy(keep), batches=2,
                             dtype=getattr(torch, dtype))
    j_rows, j_w = jax.jit(_jax_warp_chain, static_argnums=(3, 4, 5))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(keep), H, W,
        getattr(jnp, dtype))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(j_rows))
    for k in range(4):
        if dtype == "float32":
            np.testing.assert_array_equal(w[k].numpy(), np.asarray(j_w[k]))
        else:
            _within_bf16_ulp(w[k], j_w[k])


# --- P3 and the row gather ----------------------------------------------------

def test_corner_blend_matches_pallas_fused():
    """P3 in bf16 against the Pallas kernel ``make_pallas_fused`` (interpret
    mode) on the probe's (241*321, 64) table. The port sums in f32 and
    rounds once; the Pallas kernel rounds each of its 4 products and 3 sums
    to bf16, so the two agree within 5 unit roundoffs (5 * 2^-8) of the
    terms' magnitude sum_k |g_k w_k| (the bound of that 7-rounding chain
    plus the port's one rounding), not within an ulp of a result that
    cancellation can make small."""
    probe = _probe("pallas_gather_probe")
    rng = np.random.RandomState(3)
    n = 4096
    tbl = rng.randn(probe.M, probe.CW).astype(np.float32)
    idx = rng.randint(0, probe.M, n).astype(np.int32)
    w = rng.rand(n, 4).astype(np.float32)
    j_tbl = jnp.asarray(tbl).astype(jnp.bfloat16)
    j_w = jnp.asarray(w).astype(jnp.bfloat16)
    ref = jax.jit(probe.make_pallas_fused(n, 512, probe.CW, 16))(
        j_tbl, jnp.asarray(idx)[:, None], j_w)
    t_tbl = torch.from_numpy(tbl).bfloat16()
    t_w = torch.from_numpy(np.ascontiguousarray(w.T)).bfloat16()
    out = corner_blend(t_tbl, torch.from_numpy(idx), t_w)
    assert out.dtype == torch.bfloat16 and out.shape == (n, 16)
    g = _np(t_tbl)[idx].reshape(n, 4, 16)
    terms = np.einsum("nkc,kn->nc", np.abs(g), np.abs(_np(t_w)))
    assert np.all(np.abs(_np(out) - _np(ref)) <= 5 * BF16_EPS * terms)


@pytest.mark.parametrize("kernel", ["make_pallas_sublane",
                                    "make_pallas_take"])
def test_row_gather_matches_pallas_gather(kernel):
    """The row gather against P1 and P2 (interpret mode): exact."""
    probe = _probe("pallas_gather_probe")
    rng = np.random.RandomState(4)
    n = 2048
    tbl = jnp.asarray(rng.randn(probe.M, probe.CW).astype(np.float32)
                      ).astype(jnp.bfloat16)
    idx = rng.randint(0, probe.M, n).astype(np.int32)
    ref = jax.jit(getattr(probe, kernel)(n, 512, probe.CW))(
        tbl, jnp.asarray(idx)[:, None])
    out = row_gather(torch.from_numpy(np.array(tbl.astype(jnp.float32))
                                      ).bfloat16(), torch.from_numpy(idx))
    np.testing.assert_array_equal(_np(out), _np(ref))


def test_row_gather_matches_pallas_shuffle():
    """The row gather against P4 ``make_shuffle`` (interpret mode) at the
    probe's correctness shape (m = 1024, 16 lanes, g = 2): exact."""
    probe = _probe("pallas_shuffle_probe")
    rng = np.random.RandomState(5)
    m, lanes, g = 1024, 16, 2
    tbl = rng.randn(m, lanes).astype(np.float32)
    idx = rng.randint(0, m, (g * m, 1)).astype(np.int32)
    ref = jax.jit(probe.make_shuffle(m, lanes, g))(
        jnp.asarray(tbl).astype(jnp.bfloat16), jnp.asarray(idx))
    out = row_gather(torch.from_numpy(tbl).bfloat16(),
                     torch.from_numpy(idx[:, 0]))
    np.testing.assert_array_equal(_np(out), _np(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_corners_exact(dtype):
    x = np.random.RandomState(6).randn(2, 7, 11, 3).astype(np.float32)
    ref = j_pack_corners(jnp.asarray(x).astype(getattr(jnp, dtype)))
    out = pack_corners(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.shape == (2, 8, 12, 12)
    np.testing.assert_array_equal(_np(out), _np(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bilinear_sample_pixel_matches_jax(dtype):
    """P5 + P3 against JAX ``bilinear_sample_pixel`` (its einsum blend):
    <= 1e-6 in f32 (summation order); within 1 bf16 ulp in bf16."""
    rng = np.random.RandomState(7)
    B, H, W, C, N = 2, 13, 17, 5, 300
    img = rng.randn(B, H, W, C).astype(np.float32)
    x = rng.uniform(-2.5, W + 1.5, (B, N)).astype(np.float32)
    y = rng.uniform(-2.5, H + 1.5, (B, N)).astype(np.float32)
    ref = j_sample(jnp.asarray(img).astype(getattr(jnp, dtype)),
                   jnp.asarray(x), jnp.asarray(y))
    out = bilinear_sample_pixel(torch.from_numpy(img).to(getattr(torch,
                                                                 dtype)),
                                torch.from_numpy(x), torch.from_numpy(y))
    assert out.shape == (B, N, C) and out.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    else:
        _within_bf16_ulp(out, ref)


def test_grid_sample_bilinear_matches_jax_and_torch():
    """As tests/test_parity_layers.py:11-22: against the JAX port (1e-6)
    and torch's own grid_sample (1e-5)."""
    rng = np.random.RandomState(8)
    B, H, W, C = 2, 13, 17, 5
    img = rng.randn(B, H, W, C).astype(np.float32)
    grid = (rng.rand(B, 7, 9, 2).astype(np.float32) * 2.6 - 1.3)
    out = grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(grid))
    ref = j_grid_sample(jnp.asarray(img), jnp.asarray(grid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    theirs = F.grid_sample(
        torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(grid),
        mode="bilinear", padding_mode="zeros", align_corners=True)
    np.testing.assert_allclose(out.numpy(),
                               theirs.permute(0, 2, 3, 1).numpy(), atol=1e-5)


@pytest.mark.parametrize("pose", ["identity", "shifted"])
def test_depth_reprojection_warp_matches_jax(pose):
    """Against JAX ``depth_reprojection_warp`` (the cases of
    tests/test_aux2.py:45-80): pixels within 1e-3 px and depths within
    1e-5 relative where both masks agree; masks differ on < 0.5% of pixels
    (float32 division at the bounds)."""
    rng = np.random.RandomState(9)
    B, H, W = 1, 32, 48
    src = (rng.rand(B, H, W) * 2 + 2).astype(np.float32)
    ref = (rng.rand(B, H, W) * 2 + 2).astype(np.float32)
    K = np.array([[[40.0, 0, (W - 1) / 2], [0, 40.0, (H - 1) / 2],
                   [0, 0, 1]]], np.float32)
    c2w_ref = np.eye(4, dtype=np.float32)[None]
    c2w_src = c2w_ref.copy()
    if pose == "shifted":
        c2w_src[0, :3, 3] = [0.1, -0.05, 0.02]
    else:
        src = ref
    kw = dict(src_K=K, src_cam_to_world=c2w_src, ref_K=K,
              ref_cam_to_world=c2w_ref)
    j = j_warp3d(jnp.asarray(src), jnp.asarray(ref),
                 **{k: jnp.asarray(v) for k, v in kw.items()})
    t = depth_reprojection_warp(torch.from_numpy(src), torch.from_numpy(ref),
                                **{k: torch.from_numpy(v)
                                   for k, v in kw.items()})
    jm, tm = np.asarray(j[2]) > 0.5, t[2].numpy() > 0.5
    assert (jm != tm).mean() < 5e-3
    both = jm & tm
    assert both.mean() > 0.8
    np.testing.assert_allclose(t[0].numpy()[both], np.asarray(j[0])[both],
                               atol=1e-3)
    np.testing.assert_allclose(t[1].numpy()[both], np.asarray(j[1])[both],
                               rtol=1e-5)


# --- wrapper contracts --------------------------------------------------------

def test_wrappers_reject_bad_input():
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        bilinear_index(x.double(), x.double(), 4, 4)
    with pytest.raises(ValueError):
        bilinear_index(x, x, 4, 4, dtype=torch.float16)
    with pytest.raises(ValueError):
        bilinear_index(x, x, 4, 4, batches=3)
    with pytest.raises(ValueError):                      # int32 overflow
        bilinear_index(x, x, 2 ** 16, 2 ** 16)
    with pytest.raises(ValueError):
        bilinear_index(x, x, 4, 4, keep=torch.ones((2, 8)))
    table = torch.zeros((10, 8))
    rows = torch.zeros(6, dtype=torch.int32)
    with pytest.raises(ValueError):
        corner_blend(table, rows, torch.zeros((4, 6)).bfloat16())
    with pytest.raises(ValueError):
        corner_blend(table, rows.long(), torch.zeros((4, 6)))
    with pytest.raises(ValueError):
        corner_blend(torch.zeros((10, 6)), rows, torch.zeros((4, 6)))
    with pytest.raises(ValueError):
        row_gather(table.double(), rows)
    with pytest.raises(ValueError):
        row_gather(table, rows.long())


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU each wrapper returns its plain version's result and counts
    no launch."""
    x, y = (torch.from_numpy(a) for a in _probe_positions(9, 11, (3, 9, 11),
                                                          seed=10))
    before = (bilinear_index.launches, corner_blend.launches)
    rows, w = bilinear_index(x, y, 9, 11, dtype=torch.bfloat16)
    for a, b in zip((rows, w), bilinear_index_plain(x, y, 9, 11,
                                                    dtype=torch.bfloat16)):
        assert torch.equal(a, b)
    table = pack_corners(torch.randn(1, 9, 11, 4).bfloat16()).reshape(-1, 16)
    out = corner_blend(table, rows.reshape(-1), w.reshape(4, -1))
    assert torch.equal(out, corner_blend_plain(table, rows.reshape(-1),
                                               w.reshape(4, -1)))
    assert (bilinear_index.launches, corner_blend.launches) == before


def test_port_imports_no_jax():
    """The port, its probes and chip_smoke.py import nothing of JAX, flax
    or the JAX package (the card's machine has none of them)."""
    pkg = os.path.join(REPO, "tandem_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
        if f.endswith(".py")]
    banned = ("jax", "flax", "tandem_tpu")
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}: {name}"
