"""Tests of the port that need an NVIDIA GPU: its CUDA kernels have no CPU
mode. They skip without a card. Every kernel (the plane-sweep sample
``csrc/bilinear_sample.cu`` included) is held against its plain
PyTorch version on the card: exactly (torch.equal), or for the tracker's
sums (K6, track_lm) within a stated tolerance of a float64 evaluation.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tandem_tpu_torch.models.edge_filter import depth_filter_edges
from tandem_tpu_torch.models.layers import DeconvBnRelu
from tandem_tpu_torch.ops.bilinear_index import (bilinear_index,
                                                 bilinear_index_plain)
from tandem_tpu_torch.ops.corner_blend import corner_blend, corner_blend_plain
from tandem_tpu_torch.ops.edge_kth import edge_kth_plain, edge_kth_value
from tandem_tpu_torch.ops.bilinear_sample import pack_corners
from tandem_tpu_torch.ops.row_gather import row_gather, row_gather_plain

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


# --- P5 bilinear_index, P3 corner_blend, row_gather (P1/P2/P4) -------------

DTYPES = [torch.float32, torch.bfloat16]
B, H, W = 2, 37, 53   # odd sizes, two images in one table


def _positions(seed: int = 5):
    """Positions over the image and past both pad edges, with exact pad-edge
    cells (x0 = -1 and x0 = W - 1, likewise in y) and integer positions."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-3.0, W + 2.0, (B, 3, H, W)).astype(np.float32)
    y = rng.uniform(-3.0, H + 2.0, (B, 3, H, W)).astype(np.float32)
    x[:, 0, :, :8] = rng.uniform(-1.0, 0.0, (B, H, 8))
    x[:, 0, :, 8:16] = rng.uniform(W - 1.0, W, (B, H, 8))
    y[:, 1, :4] = rng.uniform(-1.0, 0.0, (B, 4, W))
    y[:, 1, 4:8] = rng.uniform(H - 1.0, H, (B, 4, W))
    x[:, 2, :, :6] = np.arange(-1, 5)
    keep = rng.rand(B, 3, H, W) < 0.8
    return x, y, keep


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True])
def test_bilinear_index_kernel_equals_plain(dev, dtype, masked):
    x, y, keep = (torch.from_numpy(a).to(dev) for a in _positions())
    args = (x, y, H, W, keep if masked else None, B, dtype)
    before = bilinear_index.launches
    rows, w = bilinear_index(*args)
    torch.cuda.synchronize()
    assert bilinear_index.launches == before + 1
    rows_p, w_p = bilinear_index_plain(*args)
    assert rows.dtype == torch.int32 and w.shape == (4, *x.shape)
    assert torch.equal(rows, rows_p)
    assert torch.equal(w, w_p)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [1, 3, 8, 16, 32])
def test_corner_blend_kernel_equals_plain(dev, dtype, C):
    """C = 1, 3 take the scalar path; 8-32 the vector loads of the stage
    widths (64 B rows at stage 3 in bf16 up to 512 B at stage 1 in f32)."""
    x, y, keep = (torch.from_numpy(a).to(dev) for a in _positions())
    rows, w = bilinear_index(x, y, H, W, keep, B, dtype)
    feat = torch.from_numpy(np.random.RandomState(C).randn(
        B, H, W, C).astype(np.float32)).to(dev, dtype)
    table = pack_corners(feat).reshape(-1, 4 * C)
    before = corner_blend.launches
    out = corner_blend(table, rows.reshape(-1), w.reshape(4, -1))
    torch.cuda.synchronize()
    assert corner_blend.launches == before + 1
    assert out.dtype == dtype and out.shape == (rows.numel(), C)
    assert torch.equal(out, corner_blend_plain(table, rows.reshape(-1),
                                               w.reshape(4, -1)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", [1, 3, 8, 33, 64, 128])
def test_row_gather_kernel_equals_plain(dev, dtype, width):
    rng = np.random.RandomState(width)
    tbl = torch.from_numpy(rng.randn(1001, width).astype(np.float32)).to(
        dev, dtype)
    idx = torch.from_numpy(rng.randint(0, 1001, 4099).astype(np.int32)).to(
        dev)
    before = row_gather.launches
    out = row_gather(tbl, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert torch.equal(out, row_gather_plain(tbl, idx))


def test_sample_kernels_reject_bad_input(dev):
    x = torch.zeros((2, 8), device=dev)
    with pytest.raises(ValueError):                      # positions dtype
        bilinear_index(x.double(), x.double(), 4, 4)
    with pytest.raises(ValueError):                      # non-contiguous
        bilinear_index(x.t(), x.t(), 4, 4)
    with pytest.raises(ValueError):                      # weight dtype
        bilinear_index(x, x, 4, 4, dtype=torch.float16)
    table = torch.zeros((10, 8), device=dev)
    rows = torch.zeros(6, dtype=torch.int32, device=dev)
    w = torch.zeros((4, 6), device=dev)
    with pytest.raises(ValueError):                      # weights vs table
        corner_blend(table, rows, w.bfloat16())
    with pytest.raises(ValueError):                      # table dtype
        corner_blend(table.double(), rows, w.double())
    with pytest.raises(ValueError):                      # int64 rows
        corner_blend(table, rows.long(), w)
    with pytest.raises(ValueError):                      # non-contiguous
        corner_blend(torch.zeros((8, 10), device=dev).t(), rows, w)
    with pytest.raises(ValueError):
        row_gather(table, rows.long())
    with pytest.raises(ValueError):
        row_gather(torch.zeros((8, 10), device=dev).t(), rows)
    with pytest.raises(ValueError):
        row_gather(table.half(), rows)


# --- the plane-sweep sample csrc/bilinear_sample.cu -------------------------

# Two ref->src matrices: a sweep whose positions pass both pad edges, and
# one whose source camera lies behind the nearer hypotheses (z < 0).
SWEEP_MATS = np.array(
    [[[1.08, 0.02, -2.5, 0.8], [0.01, 0.97, -1.0, 0.5],
      [5e-4, 3e-4, 0.98, 0.01]],
     [[1.02, 0.0, 1.5, -0.4], [0.0, 1.03, -2.0, 0.3],
      [1e-3, 0.0, 0.9, -1.5]]], np.float32)


def _sweep_case(dev, nb: int, C: int, dtype, seed: int, offset: int = 0):
    """(img, ref_to_src, depth) of ``nb`` images at H x W, 3 hypotheses;
    ``offset`` elements shift the image's base pointer."""
    rng = np.random.RandomState(seed)
    n = nb * H * W * C
    img = torch.empty(n + offset, dtype=dtype, device=dev)[offset:]
    img.copy_(torch.from_numpy(rng.randn(n).astype(np.float32)))
    depth = rng.uniform(0.5, 5.0, (nb, 3, H, W)).astype(np.float32)
    return (img.view(nb, H, W, C), torch.from_numpy(SWEEP_MATS[:nb]).to(dev),
            torch.from_numpy(depth).to(dev))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [1, 3, 8, 16, 32])
@pytest.mark.parametrize("nb", [1, 2])
def test_warp_sample_kernel_equals_plain(dev, dtype, C, nb):
    """The plane-sweep mode, every vector width: one launch, exact."""
    from tandem_tpu_torch.ops.bilinear_sample import (warp_sample,
                                                      warp_sample_plain)
    img, mat, depth = _sweep_case(dev, nb, C, dtype, seed=C)
    before = warp_sample.launches
    out = warp_sample(img, mat, depth)
    torch.cuda.synchronize()
    assert warp_sample.launches == before + 1
    assert out.dtype == dtype and out.shape == (nb, 3, H, W, C)
    assert torch.equal(out, warp_sample_plain(img, mat, depth))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [1, 3, 8, 16, 32])
def test_bilinear_sample_kernel_equals_plain(dev, dtype, C):
    """Given positions past both pad edges, with and without keep."""
    from tandem_tpu_torch.ops.bilinear_sample import (bilinear_sample,
                                                      bilinear_sample_plain)
    x, y, keep = (torch.from_numpy(a).to(dev).reshape(B, -1)
                  for a in _positions())
    img = torch.from_numpy(np.random.RandomState(C).randn(
        B, H, W, C).astype(np.float32)).to(dev, dtype)
    for k in (None, keep):
        before = bilinear_sample.launches
        out = bilinear_sample(img, x, y, k)
        torch.cuda.synchronize()
        assert bilinear_sample.launches == before + 1
        assert out.dtype == dtype and out.shape == (B, x.shape[1], C)
        assert torch.equal(out, bilinear_sample_plain(img, x, y, k))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,offset", [(6, 0), (12, 0), (8, 1), (32, 3)])
def test_sample_kernel_misaligned(dev, dtype, C, offset):
    """Channel counts that 16-byte vectors do not divide, and image base
    pointers off 16-byte alignment: narrower vectors, still exact."""
    from tandem_tpu_torch.ops.bilinear_sample import (bilinear_sample,
                                                      bilinear_sample_plain,
                                                      warp_sample,
                                                      warp_sample_plain)
    img, mat, depth = _sweep_case(dev, 2, C, dtype, seed=C, offset=offset)
    assert torch.equal(warp_sample(img, mat, depth),
                       warp_sample_plain(img, mat, depth))
    x, y, keep = (torch.from_numpy(a).to(dev).reshape(B, -1)
                  for a in _positions())
    assert torch.equal(bilinear_sample(img, x, y, keep),
                       bilinear_sample_plain(img, x, y, keep))


def test_bilinear_sample_rejects_bad_input(dev):
    from tandem_tpu_torch.ops.bilinear_sample import (bilinear_sample,
                                                      warp_sample)
    img = torch.zeros((1, 8, 8, 4), device=dev)
    mat = torch.zeros((1, 3, 4), device=dev)
    depth = torch.zeros((1, 2, 8, 8), device=dev)
    for bad in ((img.double(), mat, depth),              # image dtype
                (img, mat.double(), depth),              # matrix dtype
                (img, mat[:, :, :3], depth),             # matrix shape
                (img, mat, depth[:, :, :4]),             # depth shape
                (img.transpose(1, 2), mat, depth),       # non-contiguous
                (img, mat.cpu(), depth)):                # device
        with pytest.raises(ValueError):
            warp_sample(*bad)
    x = torch.zeros((1, 6), device=dev)
    for bad in ((img, x, x[:, :5]),                      # shapes differ
                (img, x.half(), x.half()),               # position dtype
                (img, x.t(), x.t()),                     # (N, 1), not (B, N)
                (img, x[:, ::2], x[:, 3:]),              # non-contiguous
                (img, x, x, torch.ones((1, 6), device=dev))):  # keep dtype
        with pytest.raises(ValueError):
            bilinear_sample(*bad)


def test_stage_ref_p2w_equals_per_view_on_card(dev):
    """plane_sweep_warp with the stage's reference pixel -> world matrix
    passed in equals computing it in the call, on the card."""
    from tandem_tpu_torch.ops.warp import plane_sweep_warp, ref_pixel_to_world
    rng = np.random.RandomState(1)
    K = torch.tensor([[[30.0, 0, 26.0], [0, 30.0, 18.0], [0, 0, 1]]],
                     device=dev)
    ref = torch.eye(4, device=dev)[None]
    feat = torch.from_numpy(rng.randn(1, H, W, 8).astype(np.float32)).to(dev)
    depth = torch.from_numpy(rng.uniform(0.5, 5.0, (1, 4, H, W)).astype(
        np.float32)).to(dev)
    p2w = ref_pixel_to_world(K, ref)
    for t in ([0.1, 0.0, 0.02], [-0.2, 0.05, 1.5]):
        src = torch.eye(4, device=dev)[None]
        src[0, :3, 3] = torch.tensor(t, device=dev)
        kw = dict(src_K=K, src_cam_to_world=src, ref_K=K,
                  ref_cam_to_world=ref, with_mask=False)
        assert torch.equal(plane_sweep_warp(feat, depth, **kw)[0],
                           plane_sweep_warp(feat, depth, ref_p2w=p2w,
                                            **kw)[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_cva_mvsnet_card_equals_plain_sample(dev, dtype, monkeypatch):
    """The whole cascade on the card (64x96, V = 3, planes 8/4/4) with the
    sample kernel and with warp_sample swapped for its plain version: equal
    outputs (cuDNN held to deterministic algorithms)."""
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.ops import warp as warp_mod
    from tandem_tpu_torch.ops.bilinear_sample import (warp_sample,
                                                      warp_sample_plain)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    torch.manual_seed(0)
    model = CvaMVSNet(depth_num=(8, 4, 4), view_aggregation=True,
                      dtype=dtype).eval().to(dev)
    rng = np.random.RandomState(0)
    Hm, Wm, V = 64, 96, 3
    image = torch.from_numpy(rng.rand(1, V, 3, Hm, Wm).astype(np.float32))
    K = np.array([[70.0, 0, (Wm - 1) / 2], [0, 70.0, (Hm - 1) / 2],
                  [0, 0, 1]], np.float32)
    Ks = [torch.from_numpy(np.concatenate([K[:2] * s, K[2:]])[None]).to(dev)
          for s in (0.25, 0.5, 1.0)]
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    for v in range(V):
        c2w[0, v, :3, 3] = [0.12 * (v - 1), 0.02 * v, 0.03 * v]
    args = (image.to(dev), Ks, torch.from_numpy(c2w).to(dev),
            torch.full((1,), 0.5, device=dev), torch.full((1,), 6.0,
                                                          device=dev))
    before = warp_sample.launches
    got = model(*args)
    assert warp_sample.launches == before + 3 * (V - 1)
    monkeypatch.setattr(warp_mod, "warp_sample", warp_sample_plain)
    ref = model(*args)
    assert warp_sample.launches == before + 3 * (V - 1)
    for a, b in zip(got, ref):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_deconv_bf16_matches_f32_cast_down(dev):
    """bf16 cuDNN ConvTranspose3d at the four-depth stages' stride (1, 2, 2)
    and output_padding (0, 1, 1) against the f32 layer on the same bf16
    input, cast down: within 2 bf16 ulps of the output's largest value."""
    torch.manual_seed(0)
    f32 = DeconvBnRelu(32, 16, stride=(1, 2, 2),
                       output_padding=(0, 1, 1)).eval()
    with torch.no_grad():
        f32.bn.running_mean.uniform_(-0.1, 0.1)
        f32.bn.running_var.uniform_(0.5, 1.5)
    bf = DeconvBnRelu(32, 16, stride=(1, 2, 2), output_padding=(0, 1, 1),
                      dtype=torch.bfloat16).eval()
    bf.load_state_dict(f32.state_dict())
    f32, bf = f32.to(dev), bf.to(dev)
    x = torch.randn((1, 32, 4, 30, 40), device=dev).bfloat16()
    with torch.no_grad():
        ref = f32(x.float())
        out = bf(x)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 16, 4, 60, 80)
    err = (out.float() - ref.bfloat16().float()).abs().max()
    assert err <= 2 * 2.0 ** -8 * ref.abs().max()


def test_probes_run_on_card(dev):
    """The three probe entry points at reduced sizes (chip_smoke runs them
    at the JAX probes' shapes)."""
    from tandem_tpu_torch.experiments import (gather_probe, idxchain_probe,
                                              shuffle_probe)
    res = gather_probe.main(sizes=(4096,), m=5000, iters=5)
    assert set(res) == {"row_gather", "corner_blend"}
    assert len(shuffle_probe.main(m=3000, lanes=(16, 64), g=2, iters=5)) == 2
    assert len(idxchain_probe.main(n=128 * 64, iters=5)) == 2


# --- K6 track_reduce, the LM kernel track_lm, the culled TSDF paths -------

def _k6_case(dev, N, B, H=61, W=83, seed=0):
    from chip_smoke import _track_case
    return _track_case(dev, N, B, H, W, seed)


def _k6_check(case):
    from chip_smoke import _double
    from tandem_tpu_torch.ops.track_reduce import (track_reduce,
                                                   track_reduce_plain)
    before = track_reduce.launches
    got = track_reduce(*case)
    torch.cuda.synchronize()
    assert track_reduce.launches == before + 1
    f32 = track_reduce_plain(*case)
    f64 = track_reduce_plain(*_double(*case))
    assert torch.equal(got[1], f32[1])                     # num
    for j in (0, 2, 3):                                    # energy, Hm, g
        err = (got[j].double() - f64[j]).abs().max()
        assert err <= 1e-4 * f64[j].abs().max().clamp_min(1e-30), j
    return got


@pytest.mark.parametrize("B", [1, 5, 15])
@pytest.mark.parametrize("N", [1, 1000, 1025, 4097])
def test_track_reduce_kernel_matches_f64(dev, B, N):
    """Odd point counts leave ragged last blocks; within 1e-4 of the
    largest |entry| of a float64 evaluation, num equal to the f32 plain."""
    _k6_check(_k6_case(dev, N, B, seed=N + B))


def test_track_reduce_kernel_empty_and_saturated(dev):
    T, aff, pts, planes, K = _k6_case(dev, 2000, 5)
    none = pts[:4] + (torch.zeros_like(pts[4]),)
    e, n, Hm, g = _k6_check((T, aff, none, planes, K))
    assert not (e.any() or n.any() or Hm.any() or g.any())
    cut = aff.clone()
    cut[:, 1] = 1000.0                      # every residual past the cutoff
    e, n, Hm, g = _k6_check((T, cut, pts, planes, K))
    assert torch.equal(e, n * 400.0) and bool((n > 0).all())
    assert not (Hm.any() or g.any())


def test_track_reduce_rejects_bad_input(dev):
    from tandem_tpu_torch.ops.track_reduce import track_reduce
    T, aff, pts, planes, K = _k6_case(dev, 300, 2)
    with pytest.raises(ValueError):
        track_reduce(T.double(), aff, pts, planes, K)
    with pytest.raises(ValueError):
        track_reduce(T, aff, pts[:4] + (pts[4].float(),), planes, K)
    with pytest.raises(ValueError):
        track_reduce(T, aff, pts, (planes[0].t(),) + planes[1:], K)
    with pytest.raises(ValueError):
        track_reduce(T, aff[:1], pts, planes, K)


@pytest.mark.parametrize("B", [1, 5, 15])
@pytest.mark.parametrize("N", [1, 1000, 1025, 4097])
def test_track_lm_step_matches_f64(dev, B, N):
    """One kernel step from a plain state against lm_step_plain in float64
    (chip_smoke._lm_one_step raises past its stated tolerances)."""
    from chip_smoke import _lm_one_step
    from tandem_tpu_torch.ops.track_lm import lm_level
    before = lm_level.launches
    _lm_one_step(dev, N, B, 61, 83, 50, seed=N + B)
    assert lm_level.launches == before + 1


@pytest.mark.parametrize("B", [1, 5, 15])
@pytest.mark.parametrize("N", [1000, 4097])
def test_track_lm_level_matches_plain(dev, B, N):
    """A whole level on the kernel against lm_level_plain on the card,
    within chip_smoke's LM_POSE_PX and LM_AFF_TOL (sums in another order
    can flip a near-tie accept)."""
    from chip_smoke import LM_AFF_TOL, LM_POSE_PX
    from tandem_tpu_torch.ops.track_lm import lm_level, lm_level_plain
    case = _k6_case(dev, N, B, seed=N + 2 * B)
    before = lm_level.launches
    got = lm_level(*case, 50)
    torch.cuda.synchronize()
    assert lm_level.launches > before
    ref = lm_level_plain(*case, 50)
    assert (got[0] - ref[0]).abs().max() <= LM_POSE_PX / case[4][0]
    assert (got[1] - ref[1]).abs().max() <= LM_AFF_TOL
    assert 0 < int(got[4]) <= 50


def test_track_lm_empty_and_saturated(dev):
    """No usable residual: the level keeps its input (n0 < 32); every
    residual past the cutoff: H = g = 0, so dx = 0 and the level stops
    after one step with the input pose."""
    from tandem_tpu_torch.ops.track_lm import lm_level, lm_level_plain
    T, aff, pts, planes, K = _k6_case(dev, 2000, 5)
    none = pts[:4] + (torch.zeros_like(pts[4]),)
    cut = aff.clone()
    cut[:, 1] = 1000.0
    for args in ((T, aff, none, planes, K), (T, cut, pts, planes, K)):
        got = lm_level(*args, 50)
        ref = lm_level_plain(*args, 50)
        assert torch.equal(got[0], args[0]) and torch.equal(got[1], args[1])
        assert torch.equal(got[0], ref[0]) and torch.equal(got[3], ref[3])
        assert int(got[4]) == int(ref[4]) == 1
    e, n = lm_level(T, cut, pts, planes, K, 50)[2:4]
    assert torch.equal(e, n * 400.0) and bool((n > 0).all())


def test_track_lm_rejects_bad_input(dev):
    from tandem_tpu_torch.ops.track_lm import lm_level, lm_steps, new_state
    T, aff, pts, planes, K = _k6_case(dev, 300, 2)
    with pytest.raises(ValueError):
        lm_level(T.double(), aff, pts, planes, K, 10)
    with pytest.raises(ValueError):
        lm_level(T, aff, tuple(p.cpu() for p in pts), planes, K, 10)
    with pytest.raises(ValueError):
        lm_level(T, aff[:1], pts, planes, K, 10)
    with pytest.raises(ValueError):                     # > 32 candidates
        lm_level(T[:1].expand(33, 4, 4).contiguous(),
                 aff[:1].expand(33, 2).contiguous(), pts, planes, K, 10)
    with pytest.raises(ValueError):                     # state of B = 1
        lm_steps(new_state(1, dev), T, aff, pts, planes, K, 10, 1)


def test_track_frame_card_matches_cpu(dev):
    """The whole tracker on the card against the CPU run (plain K6) on a
    textured plane: poses within 1e-4."""
    from tandem_tpu_torch.core.se3 import se3_exp
    from tandem_tpu_torch.tracking.coarse_tracker import (make_tracker_ref,
                                                          track_frame)
    Hh, Ww, f = 96, 128, 90.0
    cx, cy = (Ww - 1) / 2, (Hh - 1) / 2

    def render(c2w):
        u, v = np.meshgrid(np.arange(Ww, dtype=np.float64),
                           np.arange(Hh, dtype=np.float64))
        rays = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], -1)
        rays = rays @ c2w[:3, :3].T
        s = (2.0 - c2w[2, 3]) / rays[..., 2]
        p = c2w[:3, 3] + rays * s[..., None]
        img = (120 + 50 * np.sin(2.1 * p[..., 0]) * np.cos(1.7 * p[..., 1])
               + 30 * np.sin(5.3 * p[..., 0] + 1)
               + 25 * np.cos(4.3 * p[..., 1] + 2))
        return img.astype(np.float32), s.astype(np.float32)

    ref_img, ref_depth = render(np.eye(4))
    xi = torch.tensor([0.03, -0.01, 0.02, 0.008, -0.01, 0.005])
    new_img, _ = render(se3_exp(xi).double().numpy())
    out = []
    for d in (torch.device("cpu"), dev):
        ref = make_tracker_ref(torch.from_numpy(ref_img).to(d), f, f, cx, cy,
                               sparse_idepth=torch.from_numpy(
                                   1.0 / ref_depth).to(d),
                               sparse_weight=torch.ones((Hh, Ww), device=d))
        out.append(track_frame(ref, torch.from_numpy(new_img).to(d),
                               torch.eye(4, device=d),
                               torch.tensor([1.0, 0.0], device=d))["T"].cpu())
    assert (out[0] - out[1]).abs().max() <= 1e-4


def test_culled_tsdf_equals_full_on_card(dev):
    """integrate_culled and the frustum- and axis-culled renders equal the
    full walk exactly on the card (a curved surface, turned cameras)."""
    from chip_smoke import _copy_volume
    from tandem_tpu_torch.mapping import tsdf as tt
    Hh, Ww = 60, 80
    cfg = tt.TsdfConfig(voxel_size=0.02, table_dim=64, pool_size=4096,
                        truncation=0.08, max_depth=8.0)
    K = torch.tensor([[70.0, 0, (Ww - 1) / 2], [0, 70.0, (Hh - 1) / 2],
                      [0, 0, 1]], device=dev)
    u, v = np.meshgrid(np.arange(Ww), np.arange(Hh))
    depth = torch.from_numpy((2.0 + 0.5 * np.sin(u * 0.15) * np.cos(
        v * 0.12)).astype(np.float32)).to(dev)
    color = torch.full((Hh, Ww, 3), 100.0, device=dev)
    vol = tt.create_volume(cfg, dev)
    eye = torch.eye(4, device=dev)
    tt.allocate_blocks(cfg, vol, depth, K, eye)
    tt.integrate(cfg, vol, depth, color, K, eye)
    for deg in (0.0, 25.0, 50.0):
        a = np.deg2rad(deg)
        p = torch.eye(4, device=dev)
        p[0, 0], p[0, 2], p[2, 0], p[2, 2] = (np.cos(a), np.sin(a),
                                              -np.sin(a), np.cos(a))
        slots, n_vis = tt.visible_slots(cfg, vol, K, p, Hh, Ww)
        copies = [_copy_volume(vol) for _ in range(2)]
        tt.integrate(cfg, copies[0], depth, color, K, p)
        tt.integrate_culled(cfg, copies[1], depth, color, K, p, slots,
                            int(n_vis))
        for f in ("tsdf", "weight", "color"):
            assert torch.equal(getattr(copies[0], f), getattr(copies[1], f))
        s3, c3 = tt.surface_axis_slots(cfg, vol, K, p, Hh, Ww)
        full = tt.render_depth_splat(cfg, vol, K, p, Hh, Ww)
        assert torch.equal(full, tt.render_depth_splat(
            cfg, vol, K, p, Hh, Ww, slots=slots, n_visible=int(n_vis)))
        assert torch.equal(full, tt.render_depth_splat(
            cfg, vol, K, p, Hh, Ww, axis_slots=s3, axis_counts=c3.tolist()))

