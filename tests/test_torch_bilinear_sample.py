"""The plane-sweep sample in one launch (``ops/bilinear_sample.py``, kernel
``csrc/bilinear_sample.cu``): its plain versions against the chain they
replace and against the JAX package, and the wrappers' contracts.

On the CPU the wrappers run their plain versions (the kernel runs only on
the card; ``tests/test_torch_cuda.py`` holds it against these plain
versions there, bit for bit). Inputs are drawn with numpy from a seed;
tolerances are stated per test.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tandem_tpu.ops.grid_sample import bilinear_sample_pixel as j_sample
from tandem_tpu.ops.warp import plane_sweep_warp as j_warp
from tandem_tpu_torch.ops.bilinear_index import (bilinear_index_plain,
                                                 table_rows)
from tandem_tpu_torch.ops.bilinear_sample import (bilinear_sample,
                                                  bilinear_sample_plain,
                                                  pack_corners, warp_sample,
                                                  warp_sample_plain)
from tandem_tpu_torch.ops.corner_blend import corner_blend_plain
from tandem_tpu_torch.ops.warp import plane_sweep_warp, ref_pixel_to_world

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, D, H, W = 2, 3, 13, 17
ATOL = 1e-4        # tests/test_torch_mvsnet.py's f32 tolerance


def _old_positions(ref_to_src, ref_depth, Hh, Ww):
    """The positions as ops/warp.py computed them before the one-launch
    kernel, verbatim (rot/trans views of the 4x4 product)."""
    f32 = torch.float32
    rot = ref_to_src[:, :3, :3]
    trans = ref_to_src[:, :3, 3]
    gy, gx = torch.meshgrid(torch.arange(Hh, dtype=f32),
                            torch.arange(Ww, dtype=f32), indexing="ij")
    depth = ref_depth.to(f32)

    def proj_component(i):
        dir_i = (rot[:, i, 0, None, None] * gx
                 + rot[:, i, 1, None, None] * gy
                 + rot[:, i, 2, None, None])
        return dir_i[:, None] * depth + trans[:, i, None, None, None]

    z = proj_component(2)
    z_safe = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return proj_component(0) / z_safe, proj_component(1) / z_safe, z


def _old_chain(img, ref_to_src, depth, min_depth_thres):
    """The sample before the one-launch kernel: positions,
    bilinear_index_plain (P5), pack_corners, corner_blend_plain (P3)."""
    Bn, Hh, Ww, C = img.shape
    px, py, z = _old_positions(ref_to_src, depth, Hh, Ww)
    rows, w = bilinear_index_plain(px, py, Hh, Ww, ~(z < min_depth_thres), Bn,
                                   img.dtype)
    table = pack_corners(img).reshape(Bn * table_rows(Hh, Ww), 4 * C)
    out = corner_blend_plain(table, rows.reshape(-1), w.reshape(4, -1))
    return out.reshape(*px.shape, C)


# Rows 0-2 of ref->src matrices. "edges": positions run past both pad
# edges in x and y; "behind": z = 0.9 d - 1.5 + ..., negative for the near
# hypotheses (the source camera lies behind part of the sweep); "tiny z":
# |z| = 1e-12 d, within 1e-12 of 0 for d < 1, so the 1e-12 clamp decides.
MATS = {
    "edges": [[1.08, 0.02, -2.5, 0.8], [0.01, 0.97, -1.0, 0.5],
              [5e-4, 3e-4, 0.98, 0.01]],
    "behind": [[1.02, 0.0, 1.5, -0.4], [0.0, 1.03, -2.0, 0.3],
               [1e-3, 0.0, 0.9, -1.5]],
    "tiny z": [[1.0, 0.0, 0.5, 0.0], [0.0, 1.0, -0.5, 0.0],
               [0.0, 0.0, 1e-12, 0.0]],
}


def _sweep(kinds, C, dtype, seed):
    """(img, ref_to_src (4x4 and its rows 0-2), depth) for one image per
    matrix kind."""
    rng = np.random.RandomState(seed)
    m = np.tile(np.eye(4, dtype=np.float32), (len(kinds), 1, 1))
    m[:, :3] = [MATS[k] for k in kinds]
    img = torch.from_numpy(rng.randn(len(kinds), H, W, C).astype(np.float32))
    depth = rng.uniform(0.5, 5.0, (len(kinds), D, H, W)).astype(np.float32)
    depth[:, 0, :, :4] = rng.uniform(0.5, 1.5, (len(kinds), H, 4))
    m4 = torch.from_numpy(m)
    return (img.to(dtype), m4, m4[:, :3].contiguous(),
            torch.from_numpy(depth))


# --- (a) the plain version equals the chain it replaces ----------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [1, 3, 8, 32])
@pytest.mark.parametrize("kinds,min_depth", [(("edges", "behind"), 0.001),
                                             (("tiny z", "edges"), -1.0)])
def test_warp_sample_plain_equals_old_chain(dtype, C, kinds, min_depth):
    """Bit for bit (torch.equal), B = 2. The "tiny z" image keeps its
    samples (min_depth_thres -1): their z is clamped to 1e-12, their
    positions land far outside and read zero."""
    img, m4, mat, depth = _sweep(kinds, C, DTYPES[dtype], seed=C)
    got = warp_sample_plain(img, mat, depth, min_depth)
    assert got.shape == (B, D, H, W, C) and got.dtype == DTYPES[dtype]
    assert torch.equal(got, _old_chain(img, m4, depth, min_depth))
    z = _old_positions(m4, depth, H, W)[2]
    if "behind" in kinds:     # the case is live: both kinds of samples
        assert (z < 0).any() and (z > 1).any()
        assert (got[1][z[1] < min_depth] == 0).all()
    else:
        assert (z[0].abs() < 1e-12).any() and (z[0].abs() >= 1e-12).any()
    assert (got != 0).any()


# --- (b) plane_sweep_warp against the JAX warp ------------------------------

def _cameras():
    """Ref (view 0) and two source views 5x7 px apart at 32x48, and a
    source camera 3 m ahead, behind part of the sweep."""
    K = np.array([[[35.0, 0, 23.5], [0, 35.0, 15.5], [0, 0, 1]]], np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))[:, None]
    for v in (1, 2):
        a = 0.03 * v
        c2w[v, 0, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                             [-np.sin(a), 0, np.cos(a)]]
        c2w[v, 0, :3, 3] = [0.12 * v, 0.02 * v, 0.03 * v]
    back = c2w[2].copy()
    back[0, 2, 3] = 3.0
    return K, c2w[0], {"view1": c2w[1], "view2": c2w[2], "behind": back}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("src", ["view1", "view2", "behind"])
def test_plane_sweep_warp_matches_jax(dtype, src):
    """Through warp_sample's plain version against JAX
    ``plane_sweep_warp``: f32 within ATOL (the masks differ on < 0.1% of
    samples, float32 division at the bounds); bf16 within the bound of
    tests/test_torch_bf16.py::test_plane_sweep_warp_bf16 (5 unit roundoffs
    of each sample's terms sum_k |g_k| w_k, plus 2^-8 of the largest)."""
    rng = np.random.RandomState(11)
    K, ref_c2w, srcs = _cameras()
    feat = rng.randn(1, 32, 48, 16).astype(np.float32)
    if dtype == "bfloat16":
        feat = np.array(jnp.asarray(feat).astype(jnp.bfloat16)
                        .astype(jnp.float32))
    depth = (0.5 + 5 * rng.rand(1, 4, 32, 48)).astype(np.float32)
    kw = dict(src_K=K, src_cam_to_world=srcs[src], ref_K=K,
              ref_cam_to_world=ref_c2w)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    w_j, m_j = j_warp(jnp.asarray(feat).astype(getattr(jnp, dtype)),
                      jnp.asarray(depth),
                      **{k: jnp.asarray(v) for k, v in kw.items()})
    w_t, m_t = plane_sweep_warp(torch.from_numpy(feat).to(DTYPES[dtype]),
                                torch.from_numpy(depth), **tkw)
    assert w_t.shape == (1, 4, 32, 48, 16) and w_t.dtype == DTYPES[dtype]
    assert (m_t.float().numpy() != np.asarray(m_j.astype(jnp.float32))
            ).mean() < 1e-3
    err = np.abs(w_t.float().numpy() - np.asarray(w_j.astype(jnp.float32)))
    if dtype == "float32":
        assert err.max() <= ATOL
    else:
        terms, _ = plane_sweep_warp(torch.from_numpy(np.abs(feat)),
                                    torch.from_numpy(depth), **tkw)
        terms = terms.numpy()
        assert np.all(err <= 5 * 2.0 ** -8 * terms
                      + 2.0 ** -8 * terms.max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_plane_sweep_warp_without_mask(dtype):
    """with_mask=False returns None for the mask and the same volume."""
    rng = np.random.RandomState(12)
    K, ref_c2w, srcs = _cameras()
    feat = torch.from_numpy(rng.randn(1, 32, 48, 8).astype(np.float32))
    depth = torch.from_numpy((0.5 + 5 * rng.rand(1, 4, 32, 48)
                              ).astype(np.float32))
    kw = dict(src_K=torch.from_numpy(K),
              src_cam_to_world=torch.from_numpy(srcs["behind"]),
              ref_K=torch.from_numpy(K),
              ref_cam_to_world=torch.from_numpy(ref_c2w))
    feat = feat.to(DTYPES[dtype])
    w, m = plane_sweep_warp(feat, depth, **kw)
    w0, m0 = plane_sweep_warp(feat, depth, with_mask=False, **kw)
    assert m0 is None and m.shape == (1, 4, 32, 48)
    assert torch.equal(w, w0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plane_sweep_warp_with_the_stages_ref_p2w(dtype):
    """The reference's pixel -> world matrix computed once for a stage (as
    models/cva_mvsnet.py passes it) gives the same volume, bit for bit,
    as computing it in each call."""
    rng = np.random.RandomState(14)
    K, ref_c2w, srcs = _cameras()
    feat = torch.from_numpy(rng.randn(1, 32, 48, 8).astype(np.float32))
    depth = torch.from_numpy((0.5 + 5 * rng.rand(1, 4, 32, 48)
                              ).astype(np.float32))
    Kt, ref = torch.from_numpy(K), torch.from_numpy(ref_c2w)
    p2w = ref_pixel_to_world(Kt, ref)
    for src in srcs.values():
        kw = dict(src_K=Kt, src_cam_to_world=torch.from_numpy(src), ref_K=Kt,
                  ref_cam_to_world=ref, with_mask=False)
        w, _ = plane_sweep_warp(feat.to(DTYPES[dtype]), depth, **kw)
        w2, _ = plane_sweep_warp(feat.to(DTYPES[dtype]), depth, ref_p2w=p2w,
                                 **kw)
        assert torch.equal(w, w2)


# --- (c) bilinear_sample_plain against JAX bilinear_sample_pixel -----------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [1, 8, 32])
def test_bilinear_sample_plain_matches_jax(dtype, C):
    """<= 1e-6 in f32 (JAX's einsum sums in another order); within 1 bf16
    ulp of JAX's result in bf16."""
    rng = np.random.RandomState(13 + C)
    N = 400
    img = rng.randn(B, H, W, C).astype(np.float32)
    x = rng.uniform(-2.5, W + 1.5, (B, N)).astype(np.float32)
    y = rng.uniform(-2.5, H + 1.5, (B, N)).astype(np.float32)
    x[:, :6] = [-1.0, -0.5, 0.0, W - 1.0, W - 0.5, W]
    ref = np.asarray(j_sample(jnp.asarray(img).astype(getattr(jnp, dtype)),
                              jnp.asarray(x), jnp.asarray(y)
                              ).astype(jnp.float32))
    out = bilinear_sample_plain(torch.from_numpy(img).to(DTYPES[dtype]),
                                torch.from_numpy(x), torch.from_numpy(y))
    assert out.shape == (B, N, C) and out.dtype == DTYPES[dtype]
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-6)
    else:
        ulp = np.where(ref == 0, 0.0, 2.0 ** (np.floor(np.log2(
            np.maximum(np.abs(ref), 1e-38))) - 7))
        assert np.all(np.abs(out - ref) <= ulp)


# --- (d) the wrappers' contracts, on the CPU ---------------------------------

def _good():
    img = torch.zeros((1, 8, 8, 4))
    return img, torch.zeros((1, 3, 4)), torch.zeros((1, 2, 8, 8))


BAD_SWEEPS = {
    "image dtype": lambda i, m, d: (i.double(), m, d),
    "image rank": lambda i, m, d: (i[0], m, d),
    "matrix dtype": lambda i, m, d: (i, m.double(), d),
    "matrix shape": lambda i, m, d: (i, torch.zeros((1, 4, 4)), d),
    "depth shape": lambda i, m, d: (i, m, d[..., :4]),
    "non-contiguous": lambda i, m, d: (i.transpose(1, 2), m, d),
    "device": lambda i, m, d: (i, m.to("meta"), d),
    "meta device": lambda i, m, d: (i.to("meta"), m.to("meta"),
                                    d.to("meta")),
}


@pytest.mark.parametrize("case", BAD_SWEEPS)
def test_warp_sample_rejects_bad_input(case):
    with pytest.raises(ValueError):
        warp_sample(*BAD_SWEEPS[case](*_good()))


BAD_SAMPLES = {
    "position dtype": lambda i, x: (i, x.double(), x.double()),
    "position shapes": lambda i, x: (i, x, x[:, :5]),
    "position rank": lambda i, x: (i, x[0], x[0]),
    "batch": lambda i, x: (i, torch.zeros((2, 6)), torch.zeros((2, 6))),
    "non-contiguous": lambda i, x: (i, x[:, ::2], x[:, 3:]),
    "keep dtype": lambda i, x: (i, x, x, torch.ones((1, 6))),
    "keep shape": lambda i, x: (i, x, x, torch.ones((1, 5), dtype=bool)),
    "device": lambda i, x: (i, x.to("meta"), x),
}


@pytest.mark.parametrize("case", BAD_SAMPLES)
def test_bilinear_sample_rejects_bad_input(case):
    with pytest.raises(ValueError):
        bilinear_sample(*BAD_SAMPLES[case](torch.zeros((1, 8, 8, 4)),
                                           torch.zeros((1, 6))))


def test_cpu_wrappers_take_the_plain_versions():
    """On the CPU each wrapper returns its plain version's result and counts
    no launch."""
    img, m4, mat, depth = _sweep(("edges", "behind"), 8, torch.bfloat16, 5)
    x = torch.from_numpy(np.random.RandomState(6).uniform(
        -2, W + 1, (B, 50)).astype(np.float32))
    before = (warp_sample.launches, bilinear_sample.launches)
    assert torch.equal(warp_sample(img, mat, depth),
                       warp_sample_plain(img, mat, depth))
    assert torch.equal(bilinear_sample(img, x, x.flip(1).contiguous()),
                       bilinear_sample_plain(img, x, x.flip(1)))
    assert (warp_sample.launches, bilinear_sample.launches) == before
