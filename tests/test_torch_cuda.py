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
from tandem_tpu_torch.ops.edge_kth import (KERNELS_PER_CALL, MAX_BATCH,
                                           edge_filter, edge_filter_plain,
                                           edge_kth_plain, edge_kth_value)
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


def _filter_case(kind: str, shape):
    """depth, conf (CUDA-ready numpy) and ranks k = 0, the 10% discard
    and N - 1 over the images."""
    rng = np.random.RandomState(4)
    if kind == "all_equal":
        depth = np.full(shape, 1.5, np.float32)
    elif kind == "heavy":
        depth = (np.clip(np.abs(rng.standard_cauchy(shape)), 0, 1e6)
                 * 1e-3).astype(np.float32)
    else:
        depth = _depth(kind, shape)
    n = shape[1] * shape[2]
    ranks = [(0, int(np.float32(n * 0.9)), n - 1)[b % 3]
             for b in range(shape[0])]
    return depth, rng.rand(*shape).astype(np.float32), ranks


@pytest.mark.parametrize("with_conf", [True, False])
@pytest.mark.parametrize("kind", ["random", "tied", "border", "all_equal",
                                  "heavy"])
@pytest.mark.parametrize("shape", [(3, 61, 83), (1, 120, 160), (3, 37, 5)])
def test_edge_filter_kernel_equals_plain(dev, kind, shape, with_conf):
    """The whole filter, kernel against plain: depth, confidence and mask
    equal, and the threshold equal to torch.kthvalue of the edge values."""
    depth, conf, ranks = _filter_case(kind, shape)
    d = torch.from_numpy(depth).to(dev)
    c = torch.from_numpy(conf).to(dev) if with_conf else None
    before = edge_filter.launches
    got = edge_filter(d, ranks, c)
    torch.cuda.synchronize()
    assert edge_filter.launches == before + KERNELS_PER_CALL
    ref = edge_filter_plain(d, ranks, c)
    assert got.mask.dtype == torch.bool
    for a, b in zip(got, ref):
        assert (a is None and b is None) or torch.equal(a, b)
    edge = edge_kth_plain(d).reshape(shape[0], -1)
    kth = torch.stack([torch.kthvalue(edge[b], k + 1).values
                       for b, k in enumerate(ranks)])
    assert torch.equal(got.threshold, kth)


def test_edge_filter_device_launches_a_call(dev):
    """At most 5 device launches a call (the memset of the histograms and
    four kernels), no host-to-device copy, and the kernels the profiler
    sees are the launches the wrapper counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    depth, conf, ranks = _filter_case("random", (1, 480, 640))
    d, c = torch.from_numpy(depth).to(dev), torch.from_numpy(conf).to(dev)
    edge_filter(d, ranks, c)
    torch.cuda.synchronize()
    before = edge_filter.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        edge_filter(d, ranks, c)
        torch.cuda.synchronize()
    events = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
    assert 0 < sum(e.count for e in events) <= KERNELS_PER_CALL + 1
    assert not any("Memcpy" in e.key for e in events), [e.key for e in events]
    kernels = sum(e.count for e in events if "Memset" not in e.key)
    assert kernels == edge_filter.launches - before == KERNELS_PER_CALL


def test_edge_filter_rejects_bad_input(dev):
    d = torch.zeros((1, 8, 8), device=dev)
    with pytest.raises(ValueError):
        edge_filter(d.double(), [0])
    with pytest.raises(ValueError):
        edge_filter(torch.zeros((1, 8, 16), device=dev)[..., ::2], [0])
    with pytest.raises(ValueError):
        edge_filter(d, [0], torch.zeros((1, 8, 8)))
    with pytest.raises(ValueError):
        edge_filter(torch.zeros((MAX_BATCH + 1, 8, 8), device=dev),
                    [0] * (MAX_BATCH + 1))


def test_runner_normalization_on_card(dev):
    """uint8 -> [0, 1] on the card equals numpy's / 255.0 for all 256
    values (the runner divides by a tensor, not a Python float)."""
    from tandem_tpu_torch.pipeline import mvsnet_runner
    runner = object.__new__(mvsnet_runner.MvsnetRunner)
    runner._u8_scale = torch.tensor(255.0, device=dev)
    u8 = np.arange(256, dtype=np.uint8)
    got = runner.normalize(torch.from_numpy(u8).to(dev)).cpu().numpy()
    want = u8.astype(np.float32) / 255.0
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_f32_golden_forward_is_deterministic(dev):
    """The trained 640x480 unit's f32 forward, twice in one process: all
    12 outputs equal bit for bit (the model pins cuDNN to deterministic
    algorithms)."""
    import json
    from pathlib import Path

    from tandem_tpu_torch.models.convert import (flax_to_state_dict,
                                                 load_variables)
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    unit = Path(__file__).resolve().parent.parent / "exported" / "tandem"
    cfg = json.loads((unit / "model_config.json").read_text())
    model = CvaMVSNet(**cfg)
    model.load_state_dict(flax_to_state_dict(
        load_variables(unit / "model_variables.pkl"),
        view_aggregation=model.view_aggregation))
    model = model.to(dev).eval()
    pack = np.load(unit / "sample_inputs.npz")
    args = (torch.from_numpy(pack["image"].astype(np.float32) / 255.0).to(dev),
            [torch.from_numpy(pack[k]).to(dev) for k in ("K1", "K2", "K3")],
            torch.from_numpy(pack["cam_to_world"]).to(dev),
            torch.from_numpy(pack["depth_min"]).to(dev),
            torch.from_numpy(pack["depth_max"]).to(dev),
            torch.full((1,), float(pack["discard_percentage"])))
    first, second = model(*args), model(*args)
    for a, b in zip(first, second):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


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


def test_exported_program_equals_eager_on_card(dev, tmp_path):
    """tandem_export's program exported on the card (64x96, V = 4, planes
    8/4/4, random weights) and loaded from model.pt2: its four outputs equal
    the eager f32 model's stage-3 forward bit for bit, and a run launches
    the plane-sweep kernel once a source view and stage and the edge
    filter's C call once (the custom ops' CUDA implementations)."""
    from types import SimpleNamespace

    from tandem_tpu_torch.cli import tandem_export as te
    from tandem_tpu_torch.models.convert import state_dict_to_flax
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet, Stage3Forward
    from tandem_tpu_torch.ops.bilinear_sample import warp_sample
    torch.manual_seed(0)
    V = 4
    variables = state_dict_to_flax(CvaMVSNet(depth_num=(8, 4, 4),
                                             view_aggregation=True)
                                   .state_dict())
    args = SimpleNamespace(width=96, height=64, view_num=V,
                           depth_num="8,4,4", view_aggregation=True,
                           discard_percentage=10.0, device="cuda",
                           data_root=None)
    inputs = te.build_inputs(args)
    path = str(tmp_path / te.PROGRAM)
    te.export_program(variables, inputs, args, path)
    program, served = te.load_program(str(tmp_path))
    assert served.type == "cuda"
    module = program.module()
    x = te.program_inputs(inputs, 10.0, dev)
    assert x[-1].device.type == "cpu"
    before = (warp_sample.launches, edge_filter.calls, edge_filter.launches)
    with torch.no_grad():
        got = module(*x)
    torch.cuda.synchronize()
    assert (warp_sample.launches - before[0], edge_filter.calls - before[1],
            edge_filter.launches - before[2]) == (3 * (V - 1), 1,
                                                  KERNELS_PER_CALL)
    with torch.no_grad():
        want = Stage3Forward(te._load_model(
            variables, te._model_kwargs_from_args(args), dev))(*x)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    with pytest.raises(ValueError, match="exported for cuda"):
        te.load_program(str(tmp_path), "cpu")


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
        copies = [tt.copy_volume(vol) for _ in range(2)]
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



def _textured_plane(c2w, Hh=120, Ww=160, f=150.0):
    """Intensity and z-depth of a textured plane z_w = 2 seen from c2w."""
    cx, cy = (Ww - 1) / 2, (Hh - 1) / 2
    u, v = np.meshgrid(np.arange(Ww, dtype=np.float64),
                       np.arange(Hh, dtype=np.float64))
    rays = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], -1)
    rays = rays @ c2w[:3, :3].T
    s = (2.0 - c2w[2, 3]) / rays[..., 2]
    p = c2w[:3, 3] + rays * s[..., None]
    img = (128 + 60 * np.sin(3.0 * p[..., 0]) * np.cos(2.5 * p[..., 1])
           + 40 * np.sin(7.0 * p[..., 0] + 1) + 20 * np.cos(9.0 * p[..., 1]))
    return img.astype(np.float32), s.astype(np.float32), (f, f, cx, cy)


def test_dense_match_card_matches_cpu(dev):
    """dvo's dense_match on level 1 (5 masked iterations on the device) on
    the card against the CPU: T within 1e-4, n and lambda equal."""
    from tandem_tpu_torch.tracking.dvo import build_rgbd_pyramid, dense_match
    c2w = np.eye(4)
    c2w[0, 3], c2w[2, 3] = 0.02, 0.01
    ref_i, ref_d, K = _textured_plane(np.eye(4))
    cur_i, cur_d, _ = _textured_plane(c2w)
    T0 = torch.eye(4)
    out = {}
    for d in (torch.device("cpu"), dev):
        ref = build_rgbd_pyramid(torch.from_numpy(ref_i).to(d),
                                 torch.from_numpy(ref_d).to(d), *K,
                                 num_levels=2)
        cur = build_rgbd_pyramid(torch.from_numpy(cur_i).to(d),
                                 torch.from_numpy(cur_d).to(d), *K,
                                 num_levels=2)
        out[d.type] = {k: v.cpu() for k, v in dense_match(
            ref, cur, T0.to(d), on_level=1).items()}
    a, b = out["cpu"], out["cuda"]
    assert (a["T"] - b["T"]).abs().max() <= 1e-4
    assert float(a["n"]) == float(b["n"]) > 1000
    assert float(a["lambda"]) == float(b["lambda"])
    # the match moved toward the truth (the warp is the inverse of c2w)
    assert abs(float(b["T"][0, 3]) + 0.02) < 5e-3


def test_raycast_card_matches_cpu(dev):
    """The raycast on the card against the CPU on a curved surface seen
    from a moved camera: hit masks equal on >= 99.9% of the pixels and
    depth within 1e-4 m on >= 99.5% of the pixels both hit (the card's
    sums and divisions may round a ray across a voxel face)."""
    from tandem_tpu_torch.mapping import tsdf as tt
    Hh, Ww = 60, 80
    cfg = tt.TsdfConfig(voxel_size=0.02, table_dim=64, pool_size=4096,
                        truncation=0.08, max_depth=8.0)
    u, v = np.meshgrid(np.arange(Ww), np.arange(Hh))
    depth = (2.0 + 0.4 * np.sin(u * 0.13) * np.cos(v * 0.11)).astype(
        np.float32)
    color = np.stack([128 + 100 * np.sin(u * 0.07), 100 + 0 * u,
                      60 + 0.5 * u + v], -1).astype(np.float32)
    K = np.array([[70.0, 0, (Ww - 1) / 2], [0, 70.0, (Hh - 1) / 2],
                  [0, 0, 1]], np.float32)
    pose2 = np.eye(4, dtype=np.float32)
    pose2[:3, 3] = (0.1, -0.05, 0.3)
    out = {}
    for d in (torch.device("cpu"), dev):
        vol = tt.create_volume(cfg, d)
        k, eye = torch.from_numpy(K).to(d), torch.eye(4, device=d)
        dd = torch.from_numpy(depth).to(d)
        tt.allocate_blocks(cfg, vol, dd, k, eye)
        for _ in range(2):
            tt.integrate(cfg, vol, dd, torch.from_numpy(color).to(d), k, eye)
        out[d.type] = [x.cpu().numpy() for x in tt.raycast(
            cfg, vol, (k, torch.from_numpy(pose2).to(d)), Hh, Ww)]
    (da, ca), (db, cb) = out["cpu"], out["cuda"]
    assert ((da > 0) == (db > 0)).mean() >= 0.999
    both = (da > 0) & (db > 0)
    assert both.sum() > 0.8 * da.size
    assert (np.abs(da - db)[both] <= 1e-4).mean() >= 0.995


def test_dr_debug_example_on_card(dev, tmp_path):
    """The dr_debug_example CLI on the card for two frames of
    tests/fixtures/replica_traj: the printed lines, the render PNGs, and
    the renders within the GT-depth bars (hits > 0.8, median < 2 voxels)."""
    import contextlib
    import io
    import os

    from tandem_tpu_torch.cli import dr_debug_example as cli
    from tandem_tpu_torch.data.reader import RGBDReader
    fx = os.path.join(os.path.dirname(__file__), "fixtures", "replica_traj",
                      "scene0")
    args = cli.parser.parse_args([
        "--rgb", os.path.join(fx, "images"), "--depth",
        os.path.join(fx, "depths"), "--calib",
        os.path.join(fx, "camera_dso.txt"), "--poses",
        os.path.join(fx, "gt_tum.txt"), "--out", str(tmp_path),
        "--depth-scale", "0.0002", "--limit", "2"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = cli.main(args)
    lines = buf.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["frame 0", "frame 1",
                                                  "mesh"]
    assert res["volume"].tsdf.is_cuda and res["vertices"] > 0
    reader = RGBDReader(os.path.join(fx, "images"),
                        depth_path=os.path.join(fx, "depths"),
                        depth_scale=2e-4)
    for i, r in enumerate(res["renders"]):
        assert (tmp_path / f"render_{i:04d}.png").exists()
        gt = reader.get_depth(i)
        both = (gt > 0) & (r > 0)
        assert both.sum() / (gt > 0).sum() > 0.8
        assert np.median(np.abs(r[both] - gt[both])) < 2 * 0.01


def _plane_views(n_views: int, Hh: int = 96, Ww: int = 128, f: float = 90.0):
    """A textured plane at z = 2 seen from n_views cameras moving along x:
    (images, their c2w (float32), K)."""
    from tandem_tpu_torch.core.se3 import se3_exp
    cx, cy = (Ww - 1) / 2, (Hh - 1) / 2
    u, v = np.meshgrid(np.arange(Ww, dtype=np.float64),
                       np.arange(Hh, dtype=np.float64))
    imgs, poses = [], []
    for i in range(n_views):
        c2w = se3_exp(torch.tensor([0.04 * i, -0.01 * i, 0.02 * i,
                                    0.004 * i, -0.005 * i, 0.002 * i])
                      ).double().numpy()
        rays = np.stack([(u - cx) / f, (v - cy) / f, np.ones_like(u)], -1)
        rays = rays @ c2w[:3, :3].T
        s = (2.0 - c2w[2, 3]) / rays[..., 2]
        p = c2w[:3, 3] + rays * s[..., None]
        imgs.append((120 + 50 * np.sin(2.1 * p[..., 0]) * np.cos(1.7 * p[..., 1])
                     + 30 * np.sin(5.3 * p[..., 0] + 1)
                     + 25 * np.cos(4.3 * p[..., 1] + 2)).astype(np.float32))
        poses.append(c2w.astype(np.float32))
    return imgs, poses, (f, f, cx, cy)


def test_ba_iterate_card_matches_cpu(dev):
    """K7 and the LM around it on the card against the CPU run of the same
    window (4 frames, 256 points at 2 m with 5% idepth noise, poses
    perturbed): poses within 1e-4, inverse depths within 1e-3 of the
    largest (the card divides by Python floats through rounded reciprocals
    and sums in another order; the LM's accept tests see that)."""
    from tandem_tpu_torch.core.se3 import se3_exp
    from tandem_tpu_torch.tracking.ba import (ba_iterate, create_ba_state,
                                              pattern)
    imgs, poses, K = _plane_views(4)
    rng = np.random.RandomState(0)
    N = 256
    uv = np.stack([rng.uniform(8, 120, N), rng.uniform(8, 88, N)], -1)
    uv = np.round(uv).astype(np.float32)
    host = (np.arange(N) % 2).astype(np.int64)
    noise = torch.from_numpy(rng.randn(4, 6).astype(np.float32) * 0.005)
    noise[0] = 0
    out = []
    for d in (torch.device("cpu"), dev):
        st = create_ba_state(4, N, device=d)
        p = torch.from_numpy(np.stack(poses)).to(d)
        p = p @ se3_exp(noise.to(d))
        idep = torch.full((N,), 0.5, device=d) * torch.from_numpy(
            (1 + 0.05 * np.random.RandomState(1).randn(N)).astype(
                np.float32)).to(d)
        img_t = torch.from_numpy(np.stack(imgs)).to(d)
        pat = pattern(d)
        uvt = torch.from_numpy(uv).to(d)
        hid = torch.from_numpy(host).to(d)
        col = img_t[hid[:, None], (uvt[:, 1:2] + pat[:, 1]).long(),
                    (uvt[:, 0:1] + pat[:, 0]).long()]
        st = st._replace(poses=p, frame_valid=torch.ones(4, dtype=torch.bool,
                                                         device=d),
                         pt_frame=hid, pt_uv=uvt, pt_idepth=idep,
                         pt_color=col, pt_valid=torch.ones(
                             N, dtype=torch.bool, device=d))
        new, e = ba_iterate(st, img_t, K, iters=4, newest_slot=3)
        out.append((new.poses.cpu(), new.pt_idepth.cpu(), float(e)))
    (pa, ia, ea), (pb, ib, eb) = out
    assert (pa - pb).abs().max() <= 1e-4
    assert (ia - ib).abs().max() <= 1e-3 * ia.abs().max()
    assert abs(ea - eb) <= 1e-3 * abs(ea)


def test_trace_points_card_matches_cpu(dev):
    """K8 on the card against the CPU run: statuses equal on >= 99% of the
    points (a best match within one rounding of its neighbour may differ),
    intervals within 1e-4 of the largest where the statuses agree."""
    from tandem_tpu_torch.tracking.immature import (make_immature,
                                                    trace_points)
    imgs, poses, K = _plane_views(3)
    ys, xs = np.mgrid[10:86:6, 10:118:6]
    uv = torch.from_numpy(np.stack([xs.reshape(-1), ys.reshape(-1)],
                                   -1).astype(np.float32))
    out = []
    for d in (torch.device("cpu"), dev):
        pts = make_immature(uv.to(d), torch.from_numpy(imgs[0]).to(d),
                            0.05, 2.0)
        for i in (1, 2):
            pts = trace_points(pts, torch.from_numpy(poses[0]).to(d),
                               torch.from_numpy(poses[i]).to(d),
                               torch.from_numpy(imgs[i]).to(d), K)
        out.append([x.cpu() for x in (pts.status, pts.id_min, pts.id_max)])
    (sa, lo_a, hi_a), (sb, lo_b, hi_b) = out
    same = sa == sb
    assert same.float().mean() >= 0.99
    assert (sa == 1).float().mean() > 0.5
    for a, b in ((lo_a, lo_b), (hi_a, hi_b)):
        assert (a - b)[same].abs().max() <= 1e-4 * a.abs().max()


# abl04 at 640x480: per stage (depth planes, H, W, feature channels).
ABL04_STAGES = {"stage1": (48, 120, 160, 32), "stage2": (4, 240, 320, 16),
                "stage3": (4, 480, 640, 8)}


def _grad_case(dev, stage: str, dtype, seed: int = 0, B: int = 1):
    """A plane sweep at an abl04 stage shape: grad_out, ref->src matrices
    and depths. Item 0's matrix moves the camera sideways and forward (part
    of the sweep falls outside the image) over depths of 0.2-6 m with a
    band behind the source camera; item 1 (B = 2, as training gives it)
    turns the camera and moves it back, over depths of 0.5-4 m."""
    D, Hs, Ws, C = ABL04_STAGES[stage]
    rng = np.random.RandomState(seed)
    f = 0.9 * Ws
    K = np.array([[f, 0, Ws / 2], [0, f, Hs / 2], [0, 0, 1]], np.float64)
    ang = 0.04
    Ts = [np.eye(4), np.eye(4)]
    Ts[0][:3, 3] = [0.2, -0.05, 0.5]
    Ts[1][:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                     [-np.sin(ang), 0, np.cos(ang)]]
    Ts[1][:3, 3] = [-0.1, 0.08, -0.3]
    mat = np.stack([np.concatenate([K @ T[:3, :3] @ np.linalg.inv(K),
                                    K @ T[:3, 3:]], 1)
                    for T in Ts[:B]]).astype(np.float32)
    depth = np.concatenate(
        [rng.uniform(0.2, 6.0, (1, D, Hs, Ws)),
         rng.uniform(0.5, 4.0, (1, D, Hs, Ws))][:B]).astype(np.float32)
    depth[0, :, :4] = -1.0                    # behind the source camera
    gout = torch.from_numpy(rng.randn(B, D, Hs, Ws, C).astype(np.float32))
    return (gout.to(dev, dtype), torch.from_numpy(mat).to(dev),
            torch.from_numpy(depth).to(dev))


def _assert_grad_matches_plain(acc, gout, mat, depth, tol: float = 1e-4):
    """Each batch item's float32 sums within ``tol`` of its largest
    |gradient| of the plain gradient in float64 (the same rounded weights
    and grad_out)."""
    from tandem_tpu_torch.ops.bilinear_sample import warp_sample_grad_plain
    ref = warp_sample_grad_plain(gout, mat, depth, acc_dtype=torch.float64)
    assert acc.dtype == torch.float32
    for b in range(ref.shape[0]):
        top = float(ref[b].abs().max())
        err = float((acc[b].double() - ref[b]).abs().max())
        assert top > 0 and err <= tol * top, (b, err, top)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage", list(ABL04_STAGES))
def test_warp_sample_grad_kernel_matches_plain(dev, dtype, stage, B):
    """The backward kernel at the abl04 640x480 stage shapes, B = 1 and 2
    (each item its own matrix and depths): each item's float32 sums within
    1e-4 of its largest |gradient| of the plain gradient in float64, one
    launch a call."""
    from tandem_tpu_torch.ops.bilinear_sample import warp_sample_grad
    gout, mat, depth = _grad_case(dev, stage, dtype, B=B)
    before = warp_sample_grad.launches
    acc = warp_sample_grad(gout, mat, depth)
    torch.cuda.synchronize()
    assert warp_sample_grad.launches == before + 1
    _assert_grad_matches_plain(acc, gout, mat, depth)


def _run_case(dev, stage: str, dtype, kind: str, D: int = None,
              C: int = None, hw: tuple = None, seed: int = 1):
    """A B = 2 plane sweep (an abl04 stage's D, H, W, C unless given) whose
    source cells follow ``kind`` along each pixel's planes: "one cell"
    (sorted depths within 1 mm of 2 m, the camera moved ~1 cm: every plane
    of a pixel in one cell), "alternating" (depths 1 m and 3 m in turn, the
    camera moved ~5 cm: cells A, B, A, ...), "broken" (as "one cell", but
    plane D // 3 behind the source camera, dropped, and plane 2D // 3 at
    1 mm, whose cell lies far outside the image). Item 1 moves the other
    way and down. The pattern is checked on the card's positions. Returns
    (grad_out, matrices, depths)."""
    from tandem_tpu_torch.ops.bilinear_sample import sweep_positions
    D0, Hs, Ws, C0 = ABL04_STAGES[stage]
    D, C = D or D0, C or C0
    Hs, Ws = hw or (Hs, Ws)
    rng = np.random.RandomState(seed)
    f = 0.9 * Ws
    K = np.array([[f, 0, Ws / 2], [0, f, Hs / 2], [0, 0, 1]], np.float64)
    far = kind == "alternating"
    moves = [[0.05, 0.0, 0.0], [-0.04, 0.03, 0.0]] if far else \
        [[0.01, 0.0, 0.0], [-0.006, 0.008, 0.0]]
    mat = np.stack([np.concatenate([np.eye(3), K @ np.array(t)[:, None]], 1)
                    for t in moves]).astype(np.float32)
    if far:
        depth = np.where(np.arange(D) % 2 == 0, 1.0, 3.0)[None, :, None, None] \
            * (1 + 1e-4 * rng.rand(2, D, Hs, Ws))
    else:
        depth = np.sort(2.0 + 1e-3 * rng.rand(2, D, Hs, Ws), axis=1)
    if kind == "broken":
        depth[:, D // 3] = -1.0
        depth[:, 2 * D // 3] = 1e-3
    mat_t = torch.from_numpy(mat).to(dev)
    depth_t = torch.from_numpy(depth.astype(np.float32)).to(dev)
    px, py, z = sweep_positions(mat_t, depth_t, Hs, Ws)
    live = ~(z < 0.001) & (px > -1) & (px < Ws) & (py > -1) & (py < Hs)
    cell = py.floor() * (Ws + 2) + px.floor()
    if far:
        assert float(((cell[:, 0] == cell[:, 2]) & (cell[:, 0] != cell[:, 1])
                      ).float().mean()) > 0.99
    else:
        keep = [k for k in range(D) if kind != "broken"
                or k not in (D // 3, 2 * D // 3)]
        assert float((cell[:, keep] == cell[:, :1]).all(1).float().mean()
                     ) > 0.99
        assert kind != "broken" or not live[:, [D // 3, 2 * D // 3]].any()
    gout = torch.from_numpy(rng.randn(2, D, Hs, Ws, C).astype(np.float32))
    return gout.to(dev, dtype), mat_t, depth_t


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage", ["stage1", "stage3"])
@pytest.mark.parametrize("kind", ["one cell", "alternating", "broken"])
def test_warp_sample_grad_runs_of_planes(dev, kind, stage, dtype):
    """The gradient kernel's register runs: every plane of a pixel in one
    source cell (one flush a run), cells alternating A, B, A (a flush every
    plane), a run broken by a dropped sample and by a cell outside the
    image; each item within 1e-4 of its largest |gradient| of the plain
    gradient in float64, one launch a call."""
    from tandem_tpu_torch.ops.bilinear_sample import warp_sample_grad
    gout, mat, depth = _run_case(dev, stage, dtype, kind)
    before = warp_sample_grad.launches
    acc = warp_sample_grad(gout, mat, depth)
    torch.cuda.synchronize()
    assert warp_sample_grad.launches == before + 1
    _assert_grad_matches_plain(acc, gout, mat, depth)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage,planes", [("stage1", 20), ("stage3", 3)])
def test_warp_sample_grad_ragged_plane_groups(dev, stage, planes, dtype):
    """D not a multiple of the planes a thread walks: 48 = 20 + 20 + 8
    (rounds of 8 planes cut at 20) and 4 = 3 + 1, through the launch with
    those planes; and through the wrapper on a 24x32 sweep of 45 planes,
    where grad_tiling splits D itself."""
    from tandem_tpu_torch.ops import bilinear_sample as bs
    gout, mat, depth = _run_case(dev, stage, dtype, "one cell")
    acc = bs._grad_call(gout, mat, depth, 0.001, 4, planes)
    _assert_grad_matches_plain(acc, gout, mat, depth)
    gout, mat, depth = _run_case(dev, "stage1", dtype, "alternating", D=45,
                                 hw=(24, 32))
    planes = bs.grad_tiling(2, 45, 24, 32, 8, bs._sm_count(dev.index or 0))
    assert 45 % planes != 0
    acc = bs.warp_sample_grad(gout, mat, depth)
    torch.cuda.synchronize()
    _assert_grad_matches_plain(acc, gout, mat, depth)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stage", ["stage1", "stage3"])
@pytest.mark.parametrize("offset", [1, 2])
def test_warp_sample_grad_misaligned(dev, offset, stage, dtype):
    """grad_out starting 1 or 2 elements past an aligned address: the
    lanes sum 1 channel (scalar atomics) or 2 (float2 atomics, f32 8-byte
    and bf16 4-byte aligned), within 1e-4 as the aligned case."""
    from tandem_tpu_torch.ops import bilinear_sample as bs
    gout, mat, depth = _run_case(dev, stage, dtype, "one cell")
    buf = torch.empty(gout.numel() + offset, device=dev, dtype=dtype)
    moved = buf[offset:].view(gout.shape)
    moved.copy_(gout)
    assert bs._grad_vec(gout.shape[-1], moved.element_size(),
                        moved.data_ptr()) == offset
    acc = bs.warp_sample_grad(moved, mat, depth)
    torch.cuda.synchronize()
    _assert_grad_matches_plain(acc, moved, mat, depth)


@pytest.mark.parametrize("dtype", DTYPES)
def test_warp_sample_grad_lanes_not_dividing_a_warp(dev, dtype):
    """C = 12 (3 channel vectors a pixel, which do not divide a warp): each
    lane computes its own pixel's cells; sorted narrow depths and a sweep
    with dropped and outside planes, within 1e-4."""
    from tandem_tpu_torch.ops.bilinear_sample import warp_sample_grad
    for kind in ("one cell", "broken"):
        gout, mat, depth = _run_case(dev, "stage1", dtype, kind, D=12, C=12,
                                     hw=(30, 40))
        acc = warp_sample_grad(gout, mat, depth)
        torch.cuda.synchronize()
        _assert_grad_matches_plain(acc, gout, mat, depth)


def test_warp_sample_autograd_uses_the_kernels(dev):
    """On a CUDA tensor that requires grad, warp_sample's backward is the
    kernel (one launch each way, B = 2): the float32 gradient matches the
    plain one, the bf16 gradient is the kernel's float32 sums cast once;
    the matrix and the depths may not require grad; bad grad_out raises."""
    from tandem_tpu_torch.ops.bilinear_sample import (
        warp_sample, warp_sample_grad, warp_sample_grad_plain)
    for dtype in DTYPES:
        gout, mat, depth = _grad_case(dev, "stage2", dtype, 1, B=2)
        img = torch.randn(gout.shape[:1] + gout.shape[2:], device=dev,
                          dtype=dtype, requires_grad=True)
        f0, b0 = warp_sample.launches, warp_sample_grad.launches
        out = warp_sample(img, mat, depth)
        got, = torch.autograd.grad(out, img, gout)
        torch.cuda.synchronize()
        assert (warp_sample.launches, warp_sample_grad.launches) == (
            f0 + 1, b0 + 1)
        assert got.dtype == dtype
        ref = warp_sample_grad_plain(gout, mat, depth)
        if dtype == torch.float32:
            assert float((got - ref).abs().max()) <= 1e-5 * float(
                ref.abs().max())
        else:
            # the kernel's sums differ from ref's by atomics' order only;
            # one bf16 rounding of each sum apart at most
            assert torch.allclose(got.float(), ref, rtol=2 ** -8,
                                  atol=1e-5 * float(ref.abs().max()))
    with pytest.raises(ValueError, match="no gradient"):
        warp_sample(img, mat.clone().requires_grad_(), depth)
    with pytest.raises(ValueError):
        warp_sample_grad(gout.transpose(2, 3), mat, depth)
    with pytest.raises(ValueError):
        warp_sample_grad(gout, mat, depth[:, :, :-1].contiguous())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_on_card(dev, dtype, monkeypatch):
    """One train step of the port's trainer on the card (replica_traj
    tuples 0 and 7 at 64x96, planes (8, 8, 4), V = 7): both sample kernels
    launch once a source view and stage (18 each), every backward call of
    the step (B = 2) matches the plain gradient on its own inputs, the loss
    and every gradient are finite, the parameters move, and the loss is
    within 1e-3 relative of the same step's loss on the CPU (float32;
    bf16: 5e-2)."""
    import os

    from tandem_tpu_torch import config as pcfg
    from tandem_tpu_torch.data.replica import MVSDataset, collate
    from tandem_tpu_torch.ops import bilinear_sample as bs
    from tandem_tpu_torch.ops.bilinear_sample import (warp_sample,
                                                      warp_sample_grad)
    from tandem_tpu_torch.train import trainer as pt
    calls = []

    def recording(grad_out, ref_to_src, depth, min_depth_thres=0.001):
        acc = warp_sample_grad(grad_out, ref_to_src, depth, min_depth_thres)
        if grad_out.is_cuda:   # the CPU step's backward calls it too
            calls.append((acc.clone(), grad_out.clone(), ref_to_src.clone(),
                          depth.clone()))
        return acc
    # the wrapper counts its launches on the module's name: the recorder's
    recording.launches = 0
    monkeypatch.setattr(bs, "warp_sample_grad", recording)
    config = pcfg.default()
    config.update({"MODEL.DEPTH_NUM": (8, 8, 4), "DATA.IMG_HEIGHT": 64,
                   "DATA.IMG_WIDTH": 96, "TRAIN.COMPUTE_DTYPE": dtype})
    root = os.path.join(os.path.dirname(__file__), "fixtures",
                        "replica_traj")
    batch = collate([MVSDataset(root, "val", height=64, width=96)[i]
                     for i in (0, 7)])
    losses = {}
    for where in ("cpu", dev):
        model, state = pt.create_train_state(
            config, torch.Generator().manual_seed(0), 50, device=where)
        before = [p.detach().clone() for p in model.parameters()]
        f0 = warp_sample.launches
        state, m = pt.make_train_step(model, config)(
            state, pt.batch_to_device(batch, where))
        losses[str(where)] = float(m["loss"])
        assert all(torch.isfinite(p.grad).all() for p in model.parameters())
        assert any(not torch.equal(a, p) for a, p in
                   zip(before, model.parameters()))
    torch.cuda.synchronize()
    assert (warp_sample.launches - f0, recording.launches) == (18, 18)
    assert len(calls) == 18 and calls[0][1].shape[0] == 2
    for acc, gout, mat, depth in calls:
        _assert_grad_matches_plain(acc, gout, mat, depth)
    tol = 1e-3 if dtype == "float32" else 5e-2
    assert abs(losses[str(dev)] / losses["cpu"] - 1) < tol, losses


def test_runtime_preset_on_card(dev, tmp_path):
    """tandem_dataset preset=runtime (preload=1, dense tracking) with the
    trained unit on the card: chip_smoke.py's synthetic 640x480 sequence,
    24 frames. Every frame tracked, the prefetch-free route (preload) timed
    in read_frame, keyframes made, and the backend launched K1's filter
    and the plane-sweep sample."""
    import os

    import chip_smoke
    from tandem_tpu_torch.cli import tandem_dataset
    from tandem_tpu_torch.ops.bilinear_sample import warp_sample
    from tandem_tpu_torch.ops.edge_kth import edge_filter
    chip_smoke.write_runtime_sequence(tmp_path / "seq", n=24)
    unit = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "exported", "tandem")
    before = (edge_filter.calls, warp_sample.launches)
    res = tandem_dataset.main(
        ["preset=runtime", f"files={tmp_path / 'seq' / 'images'}",
         f"calib={tmp_path / 'seq' / 'camera.txt'}",
         f"result_folder={tmp_path / 'out'}", f"mvsnet_folder={unit}",
         "dr_timing=1", "max_frames=4", "dr_mvsnet_view_num=3"], device=dev)
    fs = res["fs"]
    assert res["frames"] == 24 and not fs.is_lost
    assert len(res["timer"].intervals["read_frame"]) == 24
    assert res["backend"].call_num >= 1
    assert edge_filter.calls > before[0] and warp_sample.launches > before[1]
    assert (tmp_path / "out" / "result.txt").read_text().count("\n") == 24


def test_demo_with_the_unit_on_card(dev, tmp_path):
    """tandem_demo replay= record= with the trained unit on the card over
    tests/fixtures/replica_traj's first 24 frames: the recording replays
    through tandem_dataset to the same poses."""
    import os
    import shutil

    from tandem_tpu_torch.cli import tandem_dataset, tandem_demo
    repo = os.path.dirname(os.path.dirname(__file__))
    fx = os.path.join(repo, "tests", "fixtures", "replica_traj", "scene0")
    src = tmp_path / "src"
    src.mkdir()
    for i in range(24):
        shutil.copy(os.path.join(fx, "images", f"{i:06d}.png"), src)
    unit = os.path.join(repo, "exported", "tandem")
    res = tandem_demo.main([f"replay={src}",
                            f"calib={os.path.join(fx, 'camera_dso.txt')}",
                            f"record={tmp_path / 'rec'}",
                            f"result_folder={tmp_path / 'demo'}",
                            f"mvsnet_folder={unit}", "demo_secs=600"],
                           device=dev)
    assert res["frames"] == 24 and res["fs"].device.type == "cuda"
    assert len(os.listdir(tmp_path / "rec" / "images")) == 24
    tandem_dataset.main([f"files={tmp_path / 'rec' / 'images'}",
                         f"calib={tmp_path / 'rec' / 'camera.txt'}",
                         f"result_folder={tmp_path / 'replay'}",
                         f"mvsnet_folder={unit}",
                         "desired_immature_density=512"], device=dev)
    assert ((tmp_path / "replay" / "poses_dso.txt").read_bytes()
            == (tmp_path / "demo" / "poses_dso.txt").read_bytes())


def test_view_sharded_forward_on_card(dev):
    """The view-sharded forward over [cuda:0] * n (n = 2, 4) against the
    monolithic forward on the card (random weights, planes (8, 4, 4),
    64x96, V = 5): depth within 1e-4, confidence within 1e-3, and
    warp_sample launched once a source view and stage (12) at every n."""
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.ops.bilinear_sample import warp_sample
    from tandem_tpu_torch.parallel import build_view_sharded_forward
    from tandem_tpu_torch.train.trainer import init_parameters
    H, W, V = 64, 96, 5
    model = CvaMVSNet(depth_num=(8, 4, 4), view_aggregation=True)
    init_parameters(model, torch.Generator().manual_seed(0))
    model.to(dev)
    rng = np.random.RandomState(1)
    K = np.array([[60.0, 0, (W - 1) / 2], [0, 60.0, (H - 1) / 2],
                  [0, 0, 1]], np.float32)
    Ks = [torch.from_numpy(K * np.array([[s], [s], [1]], np.float32))[None]
          .to(dev) for s in (0.25, 0.5, 1.0)]
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    c2w[0, :, 0, 3] = 0.05 * np.arange(V)
    args = (torch.from_numpy(rng.rand(1, V, 3, H, W).astype(np.float32))
            .to(dev), Ks, torch.from_numpy(c2w).to(dev),
            torch.full((1,), 0.5, device=dev),
            torch.full((1,), 6.0, device=dev))
    ref = model(*args).stage3
    for n in (2, 4):
        before = warp_sample.launches
        d, c = build_view_sharded_forward(model, [dev] * n)(*args)
        torch.cuda.synchronize()
        assert warp_sample.launches - before == 3 * (V - 1)
        torch.testing.assert_close(d, ref.depth, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(c, ref.confidence, rtol=1e-3, atol=1e-3)


def test_data_parallel_ranks_share_the_card(dev, tmp_path):
    """2 gloo ranks on cuda:0 (replica_traj tuples 0, 3, 7, 10 at 64x64,
    planes (8, 8, 4), 2 rows a rank, 2 steps) against one process at
    world_size 2 on the global batch on the card: losses within 5e-3
    relative, equal parameters on both ranks, and each rank's steps
    launch the sample and its backward kernel 18 times a step."""
    import os

    from tandem_tpu_torch import config as pcfg
    from tandem_tpu_torch.data.replica import MVSDataset, collate
    from tandem_tpu_torch.parallel.dryrun import (run_ranks, train_rank,
                                                  train_steps)
    from tandem_tpu_torch.train import trainer as pt
    config = pcfg.default()
    config.update({"MODEL.DEPTH_NUM": (8, 8, 4), "DATA.IMG_HEIGHT": 64,
                   "DATA.IMG_WIDTH": 64})
    root = os.path.join(os.path.dirname(__file__), "fixtures",
                        "replica_traj")
    items = collate([MVSDataset(root, "val", height=64, width=64)[i]
                     for i in (0, 3, 7, 10)])
    batch = {k: items[k] for k in pt.BATCH_KEYS}
    one = train_steps(config, batch, 2, dev, world_size=2)
    ranks = run_ranks(train_rank, 2, tmp_path,
                      (config, batch, 2, "cuda:0", "gloo"), timeout=300)
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"],
                               rtol=5e-3)
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n
    for r in ranks:
        assert r["launches"] == {"bilinear_sample": 36,
                                 "warp_sample_grad": 36}


def test_train_cli_mesh_on_card(dev, tmp_path):
    """tandem_train TRAIN.DEVICE mesh on the card: one rank a card
    (spawned, NCCL), 2 steps at 64x96, one checkpoint, finite losses."""
    import os

    from tandem_tpu_torch.cli import tandem_train
    root = os.path.join(os.path.dirname(__file__), "fixtures",
                        "replica_traj")
    res = tandem_train.main(tandem_train.parser.parse_intermixed_args([
        str(tmp_path / "run"), "DATA.ROOT_DIR", root, "DATA.IMG_HEIGHT",
        "64", "DATA.IMG_WIDTH", "96", "MODEL.DEPTH_NUM", "(8, 8, 4)",
        "TRAIN.EPOCHS", "1", "TRAIN.MAX_STEPS", "2", "TRAIN.NUM_WORKERS",
        "0", "TRAIN.DEVICE", "mesh"]))
    assert res["steps"] == 2 and np.isfinite(res["losses"]).all()
    assert os.listdir(tmp_path / "run" / "ckpt") == ["step_00000002"]
