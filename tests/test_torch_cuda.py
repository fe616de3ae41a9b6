"""Tests of the port that need an NVIDIA GPU: its CUDA kernels have no CPU
mode. They skip without a card. Every kernel (the plane-sweep sample
``csrc/bilinear_sample.cu`` included) is held against its plain
PyTorch version on the card: exactly (torch.equal), or for the tracker's
sums (K6, track_lm) within a stated tolerance of a float64 evaluation.
The port's paths are held end to end on the card too: the trained unit's
golden pack and keyframes, tracking on the trajectory fixture, the SLAM
loop, the exported units, the RGB-D path, training and the evaluation,
each with the bar and the launches it must show (``torch_cases``). Timing
is the benchmark's (``benchmark/run.py``), not these tests'.
This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from tandem_tpu_torch.models.edge_filter import depth_filter_edges
from tandem_tpu_torch.models.layers import DeconvBnRelu, apply_bn, fold_bn
from tandem_tpu_torch.ops.bilinear_index import (bilinear_index,
                                                 bilinear_index_plain)
from tandem_tpu_torch.ops.corner_blend import corner_blend, corner_blend_plain
from tandem_tpu_torch.ops.edge_kth import (KERNELS_PER_CALL, MAX_BATCH,
                                           edge_filter, edge_filter_plain,
                                           edge_kth_plain, edge_kth_value)
from tandem_tpu_torch.ops.bilinear_sample import pack_corners
from tandem_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from torch_cases import (ABL04_CONFIG, BF16_STEPS, BF16_TOL, CURVE_STEPS,
                         DECONV_CONFIGS, DEMO_FRAMES, DP_RTOL, DP_SIZE, DP_STEPS, DP_TUPLES,
                         EVAL_ROOT, EVAL_TOL, EVAL_UNIT, FIXTURE, GOLDEN_TOL,
                         GT_TRACK_BOUND, LM_AFF_TOL, LM_POSE_PX,
                         MVS_TRACK_BOUND, N_KEYFRAMES, REF_ABS_REL, REPO,
                         RGBD_ATE_BOUND, RGBD_DVO_POSES, RGBD_DVO_POSES_SLACK,
                         RUNTIME_FRAMES, RUNTIME_MIN_POSES,
                         SHARD_BF16_REL, SHARD_CONF_TOL, SHARD_DEPTH_TOL,
                         SHARD_FLIP_SHARE, SHARD_FLOOR_X, SLAM_ATE_BOUND,
                         SLAM_MIN_FRAMES, SLAM_STAGE_SHAPES, STAGE_SHAPES,
                         TRAIN_ROOT, UNIT, _dense_ref, _double,
                         _golden_forward, _golden_sweep, _host_reads,
                         _lm_level_steps, _lm_one_step, _png_filtered,
                         _recorded_step, _require_step_launches, _rgbd_run,
                         _runner_outputs, _runtime_frames, _slam_run,
                         _track_case, _track_loop, _track_shapes, _train_cli,
                         _warp_positions, decoder_steps, edge_calls,
                         golden_window, load_runner, read_counts, require_edge_filter,
                         require_launched, require_not_launched, reset_counts,
                         step_inputs, write_runtime_sequence)

pytestmark = pytest.mark.cuda
# cuBLAS reads its workspace size once, at its first use: set here, when
# the tests are collected and before any of them runs, so that the
# deterministic run of test_f32_golden_forward_is_deterministic is under it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


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
@pytest.mark.parametrize("shape", [(3, 61, 83), (1, 120, 160), (3, 37, 5),
                                   (3, 480, 640), (3, 240, 320),
                                   (3, 192, 256)])
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
    """The trained 640x480 unit's f32 forward, twice in one process and a
    third time under torch.use_deterministic_algorithms (cuBLAS with its
    fixed workspace): all 12 outputs equal bit for bit (the model pins
    cuDNN to deterministic algorithms), and no op lacks a deterministic
    form."""
    runner, pack = load_runner(dev, torch.float32)
    first, second = (_golden_forward(runner, pack, dev) for _ in range(2))
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        strict = _golden_forward(runner, pack, dev)
    finally:
        torch.use_deterministic_algorithms(False)
    for again in (second, strict):
        for a, b in zip(first, again):
            for x, y in zip(a, b):
                assert torch.equal(x, y)


def _culled_equals_full(dev, cfg, vol, depth, rgb, K, pose: np.ndarray):
    """At ``pose`` and turned by 20, 40 and 60 degrees: integrate_culled
    equals integrate, and both culled renders equal the full walk."""
    from tandem_tpu_torch.mapping import tsdf as tt
    H, W = depth.shape
    for deg in (0.0, 20.0, 40.0, 60.0):
        a, turn = np.deg2rad(deg), np.eye(4, dtype=np.float32)
        turn[[0, 0, 2, 2], [0, 2, 0, 2]] = (np.cos(a), np.sin(a), -np.sin(a),
                                            np.cos(a))
        p = torch.from_numpy(pose @ turn).to(dev)
        slots, n_vis = tt.visible_slots(cfg, vol, K, p, H, W)
        n_vis = int(n_vis)
        full = tt.integrate(cfg, tt.copy_volume(vol), depth, rgb, K, p)
        cull = tt.integrate_culled(cfg, tt.copy_volume(vol), depth, rgb, K,
                                   p, slots, n_vis)
        for f in ("tsdf", "weight", "color"):
            assert torch.equal(getattr(full, f), getattr(cull, f)), (deg, f)
        ax_slots, ax_counts = tt.surface_axis_slots(cfg, vol, K, p, H, W)
        r_full = tt.render_depth_splat(cfg, vol, K, p, H, W)
        assert torch.equal(r_full, tt.render_depth_splat(
            cfg, vol, K, p, H, W, slots=slots, n_visible=n_vis)), deg
        assert torch.equal(r_full, tt.render_depth_splat(
            cfg, vol, K, p, H, W, axis_slots=ax_slots,
            axis_counts=ax_counts.tolist())), deg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_golden_pack_and_keyframes_on_card(dev, dtype):
    """The trained 640x480 unit on the card: the golden pack within
    GOLDEN_TOL (f32, the reference's boot check) or BF16_TOL, its outputs
    float32 and finite; then N_KEYFRAMES keyframes of the golden window
    through TandemBackend, the render agreeing with the MVSNet depth, and
    culled fusion equal to the full walk on that map. Launches as named."""
    from tandem_tpu_torch.mapping import tsdf as tt
    runner, pack = load_runner(dev, dtype)
    reset_counts()
    out = _golden_forward(runner, pack, dev)
    torch.cuda.synchronize()
    counts = read_counts()
    require_edge_filter("golden", counts["edge_kth"], edge_calls(), 3)
    require_launched("golden", counts, ("bilinear_sample",))
    require_not_launched("golden", counts, ("bilinear_index", "corner_blend"))
    worst = 0.0
    for s in ("stage1", "stage2", "stage3"):
        for f in ("depth", "confidence", "depth_dense", "confidence_dense"):
            got = getattr(getattr(out, s), f)
            assert got.dtype == torch.float32, (s, f)
            got = got.cpu().numpy()
            assert np.isfinite(got).all(), (s, f)
            worst = max(worst, float(np.abs(got - pack[f"out.{s}.{f}"])
                                     .mean()))
    assert worst < (GOLDEN_TOL if dtype == torch.float32 else BF16_TOL), worst

    cfg = tt.TsdfConfig()
    K = pack["K3"][0]
    H, W = runner.height, runner.width
    bgrs, _, ref_pose = golden_window(pack)
    backend = _golden_keyframes(runner, pack, cfg)
    counts = read_counts()
    require_edge_filter("keyframes", counts["edge_kth"], edge_calls(),
                        N_KEYFRAMES)
    require_launched("keyframes", counts, ("bilinear_sample",), N_KEYFRAMES)
    require_launched("keyframes", counts, ("tsdf_integrate", "tsdf_splat"),
                     N_KEYFRAMES - 1)
    require_launched("keyframes", counts, ("tsdf_fill_holes",),
                     2 * (N_KEYFRAMES - 1))
    require_not_launched("keyframes", counts,
                         ("bilinear_index", "corner_blend"))
    rdepth = backend.get_tracking_depth_map()["depth"]
    mvs = runner.get_result(device=True)["depth"]
    assert mvs.dtype == torch.float32
    rd, md = rdepth.cpu().numpy(), mvs.cpu().numpy()
    assert rd.shape == (H, W) and np.isfinite(rd).all() and (rd >= 0).all()
    want = (md >= cfg.min_depth) & (md <= cfg.max_depth)
    both = want & (rd > 0)
    assert (rd[want] > 0).mean() > 0.8
    assert np.median(np.abs(rd[both] - md[both])) < 2 * cfg.voxel_size
    rgb = torch.from_numpy(np.ascontiguousarray(
        bgrs[-2][..., ::-1], dtype=np.float32)).to(dev)
    _culled_equals_full(dev, cfg, backend.volume, mvs, rgb,
                        torch.from_numpy(K).to(dev),
                        np.asarray(ref_pose, np.float32))


def _golden_keyframes(runner, pack, cfg):
    """N_KEYFRAMES calls of TandemBackend on the golden window, the launch
    counters set to 0 before them."""
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    bgrs, poses, ref_pose = golden_window(pack)
    backend = TandemBackend(runner, cfg, pack["K3"][0], runner.height,
                            runner.width, mesh_extraction_freq=0)
    reset_counts()
    for _ in range(N_KEYFRAMES):
        backend.call(bgrs, poses, float(pack["depth_min"][0]),
                     float(pack["depth_max"][0]), ref_pose)
    torch.cuda.synchronize()
    return backend


def test_track_at_640x480_on_card(dev):
    """The tracker at the deployed size: the f32 golden keyframes' map
    rendered for golden view 0 is the dense reference, and views 1-6 are
    tracked from the identity by track_frame, by track_frame_multi over 5
    motion candidates and over the 15 rotation perturbations. The golden
    views are not photometrically consistent with their poses, so no
    accuracy bar: every pose finite, each call one track_lm launch a level
    and one K6 launch, and track_frame one host read."""
    from tandem_tpu_torch.core.se3 import se3_exp
    from tandem_tpu_torch.data.replica import gray
    from tandem_tpu_torch.mapping import tsdf as tt
    from tandem_tpu_torch.tracking.coarse_tracker import (
        NUM_LEVELS, rotation_perturbations, track_frame, track_frame_multi)
    runner, pack = load_runner(dev, torch.float32)
    backend = _golden_keyframes(runner, pack, tt.TsdfConfig())
    grays = [gray(np.ascontiguousarray(v.transpose(1, 2, 0)[..., ::-1]))
             .astype(np.float32) for v in pack["image"][0]]
    K3 = pack["K3"][0]
    dm = backend.get_tracking_depth_map()
    ref = _dense_ref(dev, dm["depth"], torch.from_numpy(np.asarray(
        dm["c2w"], np.float32)).to(dev), grays[0],
        torch.from_numpy(K3).to(dev), *(float(K3[i]) for i in (
            (0, 0), (1, 1), (0, 2), (1, 2))))
    eye = torch.eye(4, device=dev)
    aff0 = torch.tensor([1.0, 0.0], device=dev)
    moves = torch.tensor([[0.01, 0, 0, 0, 0, 0], [-0.01, 0, 0, 0, 0, 0],
                          [0, 0.01, 0, 0, 0, 0], [0, 0, 0, 0, 0.005, 0]],
                         device=dev)
    cand5 = torch.cat([eye[None], se3_exp(moves)]).contiguous()
    cand15 = torch.from_numpy(rotation_perturbations()).to(dev)
    track_frame(ref, torch.from_numpy(grays[1]).to(dev), eye, aff0)
    for v in range(1, len(grays)):
        img = torch.from_numpy(grays[v]).to(dev)
        for name, fn in (
                ("track_frame", lambda: track_frame(ref, img, eye, aff0)),
                ("multi 5", lambda: track_frame_multi(ref, img, cand5,
                                                      aff0)),
                ("multi 15", lambda: track_frame_multi(ref, img, cand15,
                                                       aff0))):
            reset_counts()
            out = {}
            reads = _host_reads(lambda: out.update(fn()))
            counts = read_counts()
            assert bool(torch.isfinite(out["T"]).all()), (v, name)
            assert (counts["track_lm"], counts["track_reduce"]) == (
                NUM_LEVELS, 1), (v, name, counts)
            assert name != "track_frame" or reads == 1, (v, reads)


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
@pytest.mark.parametrize("stage", ["stage1", "stage2", "stage3"])
@pytest.mark.parametrize("size", ["640x480", "256x192"])
def test_warp_sample_golden_sweep_equals_plain(dev, size, stage, dtype):
    """warp_sample on the golden pack's view 0 <- 1 sweep (and with half
    of it behind the moved source camera) and bilinear_sample on
    sweep-like positions, at abl04's 640x480 and the fixture's 256x192
    stage shapes: equal to the plain versions bit for bit."""
    from tandem_tpu_torch.ops.bilinear_sample import (bilinear_sample,
                                                      bilinear_sample_plain,
                                                      warp_sample,
                                                      warp_sample_plain)
    shapes = STAGE_SHAPES if size == "640x480" else SLAM_STAGE_SHAPES
    D, Hs, Ws, C = shapes[stage]
    gen = torch.Generator(device=dev).manual_seed(3)
    feat = torch.randn((1, Hs, Ws, C), generator=gen, device=dev).to(dtype)
    for behind in (True, False):
        mat, depth, _ = _golden_sweep(dev, stage, D, Hs, Ws, behind, shapes)
        assert torch.equal(warp_sample(feat, mat, depth),
                           warp_sample_plain(feat, mat, depth)), behind
    x, y, keep = (a.reshape(1, -1)
                  for a in _warp_positions(dev, gen, D, Hs, Ws))
    assert torch.equal(bilinear_sample(feat, x, y, keep),
                       bilinear_sample_plain(feat, x, y, keep))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_runner_equals_eager_on_card(dev, dtype, monkeypatch):
    """MvsnetRunner on the card (64x96, V = 4, planes 8/4/4, random
    weights) serves its stage-3 forward and edge filter from CUDA graphs:
    over three calls with other images, poses and depth ranges every
    output equals the eager ``Stage3Forward``'s on the same device inputs
    bit for bit; one graph is captured (the second call) and replayed by
    the second and third; the wrappers count each call's launches once,
    eager, captured or replayed; no tensor handed out is rewritten by a
    later call; and a second discard percentage captures a graph of its
    own, equal to the eager forward at that percentage."""
    from collections import deque

    from tandem_tpu_torch.models.convert import state_dict_to_flax
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet, Stage3Forward
    from tandem_tpu_torch.ops.bilinear_sample import warp_sample
    from tandem_tpu_torch.ops.deconv3d import deconv_bn_relu_add
    from tandem_tpu_torch.pipeline.mvsnet_runner import (GraphedStage3,
                                                         MvsnetRunner)
    from tandem_tpu_torch.utils import timer as tm
    monkeypatch.setattr(tm, "LOG", deque(maxlen=tm.LOG_ENTRIES))
    torch.manual_seed(0)
    Hm, Wm, V = 64, 96, 4
    variables = state_dict_to_flax(CvaMVSNet(depth_num=(8, 4, 4),
                                             view_aggregation=True)
                                   .state_dict())
    runner = MvsnetRunner(CvaMVSNet(depth_num=(8, 4, 4),
                                    view_aggregation=True, dtype=dtype),
                          variables, Hm, Wm, view_num=V, device=dev)
    runner.timer = tm.Timer()
    graphed = runner._forward
    assert isinstance(graphed, GraphedStage3)
    eager = Stage3Forward(runner.model)
    rng = np.random.RandomState(2)
    K = np.array([[70.0, 0, (Wm - 1) / 2], [0, 70.0, (Hm - 1) / 2],
                  [0, 0, 1]], np.float32)
    names = ("depth", "confidence", "depth_dense", "confidence_dense")

    def call(n, discard):
        bgrs = [rng.randint(0, 256, (Hm, Wm, 3), np.uint8) for _ in range(V)]
        poses = []
        for v in range(V):
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = [0.1 * (v - 1) + 0.01 * n, 0.02 * v, 0.03 * n]
            poses.append(pose)
        dmin, dmax = 0.4 + 0.1 * n, 5.0 + n
        launches = (warp_sample.launches, edge_filter.calls,
                    edge_filter.launches, deconv_bn_relu_add.launches)
        runner.call_async(bgrs, poses, K, dmin, dmax, discard)
        got = runner.get_result(device=True)
        launched = (warp_sample.launches - launches[0],
                    edge_filter.calls - launches[1],
                    edge_filter.launches - launches[2],
                    deconv_bn_relu_add.launches - launches[3])
        with torch.no_grad():
            want = eager(*runner._device_inputs(
                *runner.pack_inputs(bgrs, poses, K), dmin, dmax, discard))
        for name, w in zip(names, want):
            assert torch.equal(got[name], w[0]), (n, name)
        return got, launched

    runs = [call(n, 10.0) for n in range(3)]
    kept = [{k: v.clone() for k, v in got.items()} for got, _ in runs[:2]]
    later = [call(n, 20.0) for n in range(3, 5)]
    assert [launched for _, launched in runs + later] == [
        (3 * (V - 1), 1, KERNELS_PER_CALL, 9)] * 5
    torch.cuda.synchronize()
    for (got, _), want in zip(runs, kept):
        for name in names:
            assert torch.equal(got[name], want[name])
    outs = [x for captured in graphed._graphs.values()
            for x in captured.outputs]
    for got, _ in runs[1:] + later[1:]:
        for x in got.values():
            assert all(x.data_ptr() != y.data_ptr() for y in outs)
    samples = [(e.name, e.value) for e in tm.LOG if isinstance(e, tm.Sample)]
    assert samples.count(("mvsnet_graph_captures", 1)) == 2
    assert [v for n, v in samples if n == "mvsnet_graph_replays"] == [
        0, 1, 1, 0, 1]
    assert [v for n, v in samples if n == "deconv.launches"] == [9] * 5


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


DECONV_CASES = [(c, s, n) for c in DECONV_CONFIGS
                for s in ("stage1", "stage2", "stage3")
                for n in ("conv7", "conv9", "conv11")]
# Shapes off the main path, (Ci, Co, D, H, W) of the input and the stride:
# odd W (a thread's second input cell outside the input), D = 1, output
# channels not a multiple of 4; each in both dtypes, with and without the
# skip.
DECONV_EDGES = [((64, 32, 6, 15, 27), (2, 2, 2)),
                ((64, 32, 1, 15, 21), (1, 2, 2)),
                ((32, 16, 1, 9, 33), (2, 2, 2)),
                ((16, 8, 3, 7, 130), (2, 2, 2)),
                ((16, 10, 2, 5, 9), (1, 2, 2))]
DECONV_EDGE_IDS = {
    f"{dt}-{'x'.join(map(str, shape))}-s{''.join(map(str, stride))}":
        (dt, shape, stride)
    for shape, stride in DECONV_EDGES for dt in ("float32", "bfloat16")}
DECONV_EDGE_CASES = [("edge", i, skip) for i in DECONV_EDGE_IDS
                     for skip in ("skip", "noskip")]


def _seeded_bn(model):
    """Draw ``model``'s BatchNorm statistics and affine parameters away from
    their initial values (so that the folded BatchNorm is not 1 and 0)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.3, 2.0)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.2, 0.2)
    return model


@functools.lru_cache(maxsize=1)
def _deconv_model(config: str):
    """The configuration's CvaMVSNet on the card: the trained unit's
    weights, or seeded weights with seeded BatchNorm."""
    from tandem_tpu_torch.models.convert import (flax_to_state_dict,
                                                 load_variables)
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    kind, dtype, _, depth_num = DECONV_CONFIGS[config]
    dtype = getattr(torch, dtype)
    if kind == "unit":
        with open(UNIT / "model_config.json") as f:
            cfg = json.load(f)
        model = CvaMVSNet(**cfg, dtype=dtype)
        model.load_state_dict(flax_to_state_dict(
            load_variables(UNIT / "model_variables.pkl"),
            view_aggregation=model.view_aggregation))
    else:
        torch.manual_seed(19)
        model = _seeded_bn(CvaMVSNet(depth_num=depth_num,
                                     view_aggregation=False, dtype=dtype))
    return model.cuda().eval()


def _deconv_case(dev, config, stage, name):
    """(layer, x, skip) of a card test case: a decoder layer of the
    configuration's model at its main-path step, with seeded inputs at the
    step's shape (``decoder_steps``: recorded from the model); or, for an
    ``edge`` case, a seeded ``DeconvBnRelu`` at an edge shape."""
    if config != "edge":
        model = _deconv_model(config)
        step = {st[:2]: st for st in decoder_steps(
            model, DECONV_CONFIGS[config][2])}[(stage, name)]
        x, _, _, _, skip = step_inputs(step, model.dtype, dev,
                                       seed=len(stage + name))
        return getattr(model.cost_regularization_net[stage], name), x, skip
    dtype, shape, stride = DECONV_EDGE_IDS[stage]
    dtype = getattr(torch, dtype)
    Ci, Co, D, H, W = shape
    torch.manual_seed(sum(shape))
    layer = _seeded_bn(DeconvBnRelu(
        Ci, Co, stride=stride, output_padding=tuple(s - 1 for s in stride),
        dtype=dtype)).to(dev).eval()
    step = ("edge", "edge", Ci, Co, (D, H, W), stride)
    x, _, _, _, skip = step_inputs(step, dtype, dev, seed=sum(shape),
                                   skip=name == "skip")
    return layer, torch.cat([x, 2 * x]), None if skip is None else \
        torch.cat([skip, skip.flip(-1)])


def _eager_decoder_step(layer, x, skip, conv=None):
    """The decoder step as the eager path runs it (cuDNN's transposed
    convolution, the folded BatchNorm, the ReLU and the skip), or, given
    ``conv``, its epilogue on that convolution."""
    c, dt = layer.conv, layer.dtype
    if conv is None:
        conv = torch.nn.functional.conv_transpose3d(
            x, c.weight.to(dt), None, c.stride, c.padding, c.output_padding)
    y = torch.nn.functional.relu(apply_bn(conv, layer.bn, dt))
    return y if skip is None else skip + y


@pytest.mark.parametrize("config,stage,name",
                         DECONV_CASES + DECONV_EDGE_CASES)
def test_deconv_kernel_equals_eager_step(dev, config, stage, name):
    """Each decoder step of the three configurations at its main-path shape
    (odd H at the deepest level of stage 1, D = 1 -> 2 and stride (1, 2, 2)
    in the others), and the edge shapes in batches of 2 (odd W, D = 1, Co
    not a multiple of 4, no skip): the layer's one launch of the kernel
    against the eager step. float32 within rtol 1e-5, atol 1e-6; bfloat16
    each output equal to the eager epilogue of the eager convolution's
    value or of one of its bfloat16 neighbours (cuDNN's bfloat16 sum and
    the kernel's float32 one round apart), and within two bfloat16 ulps of
    the larger of the eager output and the scaled convolution: a one-ulp
    step of the convolution can move the rounded product by two ulps where
    the product sits on a rounding tie (abl04's stage-2 conv9: 1.1640625
    or 1.171875 times 0.3125 rounds to 0.36328125 or 0.3671875). A second
    call gives the same bits."""
    layer, x, skip = _deconv_case(dev, config, stage, name)
    dtype = layer.dtype
    reset_counts()
    with torch.no_grad():
        got = layer(x, skip=skip)
        again = layer(x, skip=skip)
        want = _eager_decoder_step(layer, x, skip)
    torch.cuda.synchronize()
    assert read_counts()["deconv"] == 2
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, again)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        return
    inf = torch.full_like(want, float("inf"))
    c, dt = layer.conv, layer.dtype
    with torch.no_grad():
        conv = torch.nn.functional.conv_transpose3d(
            x, c.weight.to(dt), None, c.stride, c.padding, c.output_padding)
        hit = torch.zeros_like(got, dtype=torch.bool)
        for cand in (torch.nextafter(conv, -inf), conv,
                     torch.nextafter(conv, inf)):
            hit |= got == _eager_decoder_step(layer, x, skip, cand)
        assert hit.all()
        scaled = conv * fold_bn(layer.bn, dt)[0].reshape(1, -1, 1, 1, 1)
        big = torch.maximum(want.abs(), scaled.abs())
        ulp = torch.nextafter(big, inf).float() - big.float()
        assert ((got.float() - want.float()).abs() <= 2 * ulp).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_golden_forward_runs_the_deconv_kernel(dev, dtype, monkeypatch):
    """The trained unit's golden forward on the card launches the decoder
    kernel 9 times (3 stages x 3 steps) and never calls conv_transpose3d;
    a training forward (train=True) and an eval forward that records a
    graph keep conv_transpose3d and launch no decoder kernel."""
    import torch.nn.functional as F
    calls = []
    real = F.conv_transpose3d

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(F, "conv_transpose3d", counted)
    runner, pack = load_runner(dev, dtype)
    reset_counts()
    _golden_forward(runner, pack, dev)
    torch.cuda.synchronize()
    assert read_counts()["deconv"] == 9 and calls == []
    net = runner.model.cost_regularization_net["stage3"]
    x = torch.rand((1, 8, 4, 32, 48), device=dev)
    for train in (True, False):
        reset_counts()
        with torch.enable_grad():
            net(x, train)
        assert read_counts()["deconv"] == 0 and len(calls) == 3
        calls.clear()
    net.requires_grad_(False)
    try:
        with torch.enable_grad():
            net(x)
    finally:
        net.requires_grad_(True)
    assert read_counts()["deconv"] == 3 and calls == []


def test_probes_run_on_card(dev):
    """The three probe entry points at reduced sizes, each launching its
    kernels (row_gather, corner_blend, bilinear_index)."""
    from tandem_tpu_torch.experiments import (gather_probe, idxchain_probe,
                                              shuffle_probe)
    reset_counts()
    res = gather_probe.main(sizes=(4096,), m=5000, iters=5)
    assert set(res) == {"row_gather", "corner_blend"}
    assert len(shuffle_probe.main(m=3000, lanes=(16, 64), g=2, iters=5)) == 2
    assert len(idxchain_probe.main(n=128 * 64, iters=5)) == 2
    require_launched("probes", read_counts(),
                     ("row_gather", "corner_blend", "bilinear_index"))


# --- K6 track_reduce, the LM kernel track_lm, the culled TSDF paths -------

def _k6_case(dev, N, B, H=61, W=83, seed=0):
    return _track_case(dev, N, B, H, W, seed)


def _k6_check(case, tdist=False):
    from tandem_tpu_torch.ops.track_reduce import (track_reduce,
                                                   track_reduce_plain)
    before = track_reduce.launches
    got = track_reduce(*case, tdist=tdist)
    torch.cuda.synchronize()
    assert track_reduce.launches == before + 1
    f32 = track_reduce_plain(*case, tdist)
    f64 = track_reduce_plain(*_double(*case), tdist)
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


@pytest.mark.parametrize("B", [1, 5, 15])
@pytest.mark.parametrize("N", [1, 1000, 2049, 5000])
def test_tdist_track_reduce_kernel_matches_f64(dev, B, N):
    """K6's Student-t mode (14 cluster reductions an evaluation) against
    the float64 plain version, as the Huber mode; 2049 and 5000 points
    take 2 and 3 CTAs a candidate."""
    _k6_check(_k6_case(dev, N, B, seed=N + B), tdist=True)


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
    (_lm_one_step raises past its stated tolerances)."""
    from tandem_tpu_torch.ops.track_lm import lm_level
    before = lm_level.launches
    _lm_one_step(dev, N, B, 61, 83, 50, seed=N + B)
    assert lm_level.launches == before + 1


@pytest.mark.parametrize("B", [1, 5, 15])
@pytest.mark.parametrize("N", [1000, 4097])
def test_track_lm_level_matches_plain(dev, B, N):
    """A whole level on the kernel against lm_level_plain on the card,
    within LM_POSE_PX and LM_AFF_TOL (sums in another order can flip a
    near-tie accept)."""
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


@pytest.mark.parametrize("B", [1, 5, 15])
@pytest.mark.parametrize("N", [1000, 4097])
def test_tdist_track_lm_level_matches_plain(dev, B, N):
    """The Student-t level on the kernel against lm_level_plain with the t
    weights on the card, within the same tolerances as the Huber level."""
    from tandem_tpu_torch.ops.track_lm import lm_level, lm_level_plain
    case = _k6_case(dev, N, B, seed=N + 2 * B)
    before = lm_level.launches
    got = lm_level(*case, 50, tdist=True)
    torch.cuda.synchronize()
    assert lm_level.launches == before + 1
    ref = lm_level_plain(*case, 50, True)
    assert (got[0] - ref[0]).abs().max() <= LM_POSE_PX / case[4][0]
    assert (got[1] - ref[1]).abs().max() <= LM_AFF_TOL
    assert 0 < int(got[4]) <= 50


@pytest.mark.parametrize("tdist", [False, True])
def test_track_lm_one_launch_a_level(dev, tdist):
    """One launch and no host read a level; every recorded step against
    the plain step, the result equal to the history's and the sums at the
    accepted poses equal to K6's (_lm_level_steps raises otherwise)."""
    from tandem_tpu_torch.ops.track_lm import lm_level
    case = _k6_case(dev, 4097, 5, seed=7)
    _lm_level_steps(dev, case, 50, "card test", tdist)
    before = lm_level.launches
    assert _host_reads(lambda: lm_level(*case, 50, tdist)) == 0
    assert lm_level.launches == before + 1


@pytest.mark.parametrize("tdist", [False, True])
@pytest.mark.parametrize("level", range(7))
def test_track_kernels_at_the_level_caps(dev, level, tdist):
    """K6 and track_lm at the tracker's level caps (``_track_shapes``),
    B = 1, 5, 15: K6 against float64, one LM step against float64, every
    step of a level against the plain step, no host read in a level, and
    the end point against lm_level_plain unless the two parted at a
    near-tie (another iteration count; never at the 640x480 cap)."""
    from tandem_tpu_torch.ops.track_lm import lm_level, lm_level_plain
    N, Hl, Wl, max_iter = _track_shapes()[level]
    for B in (1, 5, 15):
        case = _k6_case(dev, N, B, Hl, Wl, seed=10 * level + B)
        _k6_check(case, tdist)
        _lm_one_step(dev, N, B, Hl, Wl, 50, 100 + 10 * level + B, tdist)
        _, got = _lm_level_steps(dev, case, max_iter, f"level {level} B={B}",
                                 tdist)
        ref = lm_level_plain(*case, max_iter, tdist)
        close = (float((got[0] - ref[0]).abs().max())
                 <= LM_POSE_PX / case[4][0]
                 and float((got[1] - ref[1]).abs().max()) <= LM_AFF_TOL)
        parted = level > 0 and int(got[4]) != int(ref[4])
        assert bool(torch.isfinite(got[0]).all()) and (close or parted), B
        assert _host_reads(lambda: lm_level(*case, max_iter, tdist)) == 0


def test_track_lm_rejects_bad_input(dev):
    from tandem_tpu_torch.ops.track_lm import RECORD, lm_level, lm_run
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
        lm_run(T, aff, pts, planes, K, 10,
               state=torch.zeros((1, RECORD), device=dev))
    big = tuple(p.repeat(2 * 10 ** 6 // 300 + 1)[:2 * 10 ** 6].contiguous()
                for p in pts)                # t-mode r^2 past shared memory
    with pytest.raises(ValueError):
        lm_level(T, aff, big, planes, K, 10, tdist=True)


def test_track_frame_card_matches_cpu(dev):
    """The whole tracker on the card against the CPU run (plain K6) on a
    textured plane: poses within 1e-4."""
    _track_frame_card_vs_cpu(dev, False)


def test_tdist_track_frame_card_matches_cpu(dev):
    """The Student-t tracker (the RGB-D path's, track_lm in the t-mode) on
    the card against the CPU run: poses within 1e-4; one track_lm launch a
    level."""
    from tandem_tpu_torch.ops.track_lm import lm_level
    before = lm_level.launches
    _track_frame_card_vs_cpu(dev, True)
    assert lm_level.launches == before + 6


def _track_frame_card_vs_cpu(dev, tdist):
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
                               torch.tensor([1.0, 0.0], device=d),
                               tdist)["T"].cpu())
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


def test_tsdf_wall_on_card(dev):
    """tests/test_tsdf.py::test_render_depth_splat_wall at 640x480 on the
    card, default TSDF: a wall at 2 m renders with hit > 0.97 and median
    |error| < 1.5 voxels (shifted pose: > 0.9, < 2 voxels); culled fusion
    equals the full walk on it."""
    from tandem_tpu_torch.mapping import tsdf as tt
    Hh, Ww = 480, 640
    cfg = tt.TsdfConfig()
    K = torch.tensor([[499.2, 0, 319.5], [0, 499.2, 239.5], [0, 0, 1]],
                     device=dev)
    pose = torch.eye(4, device=dev)
    depth = torch.full((Hh, Ww), 2.0, device=dev)
    color = torch.full((Hh, Ww, 3), 100.0, device=dev)
    vol = tt.allocate_blocks(cfg, tt.create_volume(cfg, dev), depth, K, pose)
    for _ in range(3):
        tt.integrate(cfg, vol, depth, color, K, pose)
    crop = tt.render_depth_splat(cfg, vol, K, pose, Hh, Ww).cpu().numpy()[
        64:-64, 64:-64]
    assert (crop > 0).mean() > 0.97
    assert np.median(np.abs(crop[crop > 0] - 2.0)) < 1.5 * cfg.voxel_size
    pose2 = torch.tensor([[1, 0, 0, 0.15], [0, 1, 0, 0.0], [0, 0, 1, -0.3],
                          [0, 0, 0, 1]], dtype=torch.float32, device=dev)
    c2 = tt.render_depth_splat(cfg, vol, K, pose2, Hh, Ww).cpu().numpy()[
        80:-80, 112:-112]
    assert (c2 > 0).mean() > 0.9
    assert np.median(np.abs(c2[c2 > 0] - 2.3)) < 2 * cfg.voxel_size
    _culled_equals_full(dev, cfg, vol, depth, color, K,
                        np.eye(4, dtype=np.float32))


def test_track_against_the_gt_model_on_card(dev):
    """replica_traj's GT depths 0-6 fused on the card, the render at frame
    6 the dense reference, frames 7-14 tracked from the constant-motion
    prediction within GT_TRACK_BOUND; track_frame_multi over the 15
    rotation perturbations gives a finite pose."""
    from tandem_tpu_torch.data.replica import ReplicaScene
    from tandem_tpu_torch.mapping import tsdf as tt
    from tandem_tpu_torch.tracking.coarse_tracker import (
        rotation_perturbations, track_frame_multi)
    scene = ReplicaScene(FIXTURE)
    cfg = tt.TsdfConfig()
    K = torch.from_numpy(scene.K).to(dev)
    vol = tt.create_volume(cfg, dev)
    for i in range(7):
        d = torch.from_numpy(scene.depth(i)).to(dev)
        p = torch.from_numpy(scene.c2w(i)).to(dev)
        rgb = torch.from_numpy(np.ascontiguousarray(
            scene.bgr(i)[..., ::-1], dtype=np.float32)).to(dev)
        tt.allocate_blocks(cfg, vol, d, K, p)
        tt.integrate(cfg, vol, d, rgb, K, p)
    pose = torch.from_numpy(scene.c2w(6)).to(dev)
    slots, counts = tt.surface_axis_slots(cfg, vol, K, pose, scene.height,
                                          scene.width)
    rdepth = tt.render_depth_splat(cfg, vol, K, pose, scene.height,
                                   scene.width, axis_slots=slots,
                                   axis_counts=counts.tolist())
    reset_counts()
    ref = _dense_ref(dev, rdepth, pose, scene.gray(6), K, scene.fx,
                     scene.fy, scene.cx, scene.cy)
    errs = _track_loop(dev, scene, ref, 6, list(range(7, 15)), "track gt")
    require_launched("track gt", read_counts(), ("track_reduce", "track_lm"))
    assert max(e for e, _ in errs) < GT_TRACK_BOUND, errs
    multi = track_frame_multi(
        ref, torch.from_numpy(scene.gray(7)).to(dev),
        torch.from_numpy(rotation_perturbations()).to(dev),
        torch.tensor([1.0, 0.0], device=dev))
    assert bool(torch.isfinite(multi["T"]).all())


def test_track_against_the_mvs_model_on_card(dev):
    """tests/test_torch_tracker.py::test_track_against_the_mvs_model on the
    card (trained unit, f32): the 8 frames after the reference tracked
    within MVS_TRACK_BOUND, with the map path's and tracker's launches."""
    import json

    from tandem_tpu_torch.data.replica import ReplicaScene
    from tandem_tpu_torch.mapping.tsdf import TsdfConfig
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
    scene = ReplicaScene(FIXTURE)
    cfg = json.loads((UNIT / "model_config.json").read_text())
    runner = MvsnetRunner(CvaMVSNet(**cfg, dtype=torch.float32),
                          load_variables(UNIT / "model_variables.pkl"),
                          scene.height, scene.width, view_num=7, device=dev)
    backend = TandemBackend(runner, TsdfConfig(), scene.K, scene.height,
                            scene.width)
    reset_counts()
    for window in scene.windows[:2]:
        depths = [scene.depth(i) for i in window]
        valid = np.concatenate([d[d > 0] for d in depths])
        backend.call([scene.bgr(i) for i in window],
                     [scene.c2w(i) for i in window], float(valid.min()),
                     float(valid.max()), scene.c2w(window[-1]))
    ref_id = scene.windows[1][-1]
    dm = backend.get_tracking_depth_map()
    K = torch.from_numpy(scene.K).to(dev)
    c2w = torch.from_numpy(np.asarray(dm["c2w"], np.float32)).to(dev)
    ref = _dense_ref(dev, dm["depth"], c2w, scene.gray(ref_id), K, scene.fx,
                     scene.fy, scene.cx, scene.cy)
    errs = _track_loop(dev, scene, ref, ref_id,
                       list(range(ref_id + 1, ref_id + 9)), "track mvs")
    counts = read_counts()
    require_edge_filter("track mvs", counts["edge_kth"], edge_calls(), 2)
    require_launched("track mvs", counts,
                     ("bilinear_sample", "track_reduce", "track_lm"))
    require_not_launched("track mvs", counts,
                         ("bilinear_index", "corner_blend"))
    assert max(e for e, _ in errs) <= MVS_TRACK_BOUND, errs


# --- The fusion kernels (csrc/tsdf_fuse.cu) ----------------------------------

# The mapping cells' images: (H, W, fx = fy).
TSDF_SHAPES = {"640x480": (480, 640, 375.0), "1152x864": (864, 1152, 675.0)}


def _turn_pose(deg: float, t=(0.0, 0.0, 0.0)) -> np.ndarray:
    """A camera turned ``deg`` about y, tilted 7 degrees about x (so that
    every entry of a turned camera's rotation is nonzero), at ``t``."""
    a, b = np.deg2rad(deg), np.deg2rad(7.0)
    ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                   [0, np.sin(b), np.cos(b)]])
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = ry @ rx
    p[:3, 3] = t
    return p


def _tsdf_case(dev, shape: str, scene: str):
    """A volume fused by the plain integrator from two cameras onto a curved
    wall ~2 m away, at a mapping cell's image size, and the next scan:
    (cfg, volume with the scan's band allocated, (depth, rgb, K, pose),
    render pose). Scenes: ``wall``; ``turn80``, the camera turned 80
    degrees onto a small patch, so most blocks leave the frustum; ``grown``,
    a pool of 1,024 blocks grown until the band fits; ``edge``, an arena of
    48 blocks an axis (+-1.92 m), so the wall's far blocks lie on its edge
    and their +z neighbours outside it."""
    from tandem_tpu_torch.mapping import tsdf as tt
    H, W, f = TSDF_SHAPES[shape]
    K = torch.tensor([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]],
                     device=dev)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    wall = (2.013 + 0.3 * torch.sin(u * (7.0 / W)) * torch.cos(v * (5.0 / H))
            ).contiguous()
    rgb = torch.stack([100 + 150 * u / W, 60 + 190 * v / H,
                       200 - 150 * u / W], -1).contiguous()
    cfg = tt.TsdfConfig(**{"grown": {"pool_size": 1024},
                           "edge": {"table_dim": 48}}.get(scene, {}))
    vol = tt.create_volume(cfg, dev)

    def allocate(depth, pose):
        nonlocal cfg, vol
        tt.allocate_blocks(cfg, vol, depth, K, pose)
        while vol.n_dropped:
            cfg, vol = tt.grow_volume(cfg, vol)
            vol.n_dropped = 0
            tt.allocate_blocks(cfg, vol, depth, K, pose)

    for p in (_turn_pose(0.0), _turn_pose(10.0, (0.1, -0.05, 0.15))):
        pose = torch.from_numpy(p).to(dev)
        allocate(wall, pose)
        tt.integrate_plain(cfg, vol, wall, rgb, K, pose)
    if scene == "turn80":
        depth = torch.zeros_like(wall)
        depth[H // 3:H // 2, W // 3:W // 2] = 1.5
        pose = torch.from_numpy(_turn_pose(80.0)).to(dev)
    else:
        depth = (wall + 0.01).contiguous()
        pose = torch.from_numpy(_turn_pose(5.0, (0.05, 0.02, -0.1))).to(dev)
    allocate(depth, pose)
    if scene == "grown":
        assert cfg.pool_size > 1024
    return cfg, vol, (depth, rgb, K, pose), pose


@pytest.mark.parametrize("scene", ["wall", "turn80", "grown", "edge"])
@pytest.mark.parametrize("shape", list(TSDF_SHAPES))
def test_tsdf_kernels_equal_plain(dev, shape, scene):
    """integrate, splat_zbuf's full walk, _fill_holes (from the z-buffer and
    from a depth map) and render_depth_splat on the card, one launch each
    (two for the fill), equal their plain versions bit for bit."""
    from tandem_tpu_torch.mapping import tsdf as tt
    cfg, vol, (depth, rgb, K, pose), render = _tsdf_case(dev, shape, scene)
    H, W = depth.shape
    if scene == "turn80":
        _, n_vis = tt.visible_slots(cfg, vol, K, pose, H, W)
        assert int(n_vis) < 0.2 * vol.n_allocated
    got, want = tt.copy_volume(vol), tt.copy_volume(vol)
    counts = [tt.integrate.launches, tt.splat_zbuf.launches,
              tt._fill_holes.launches]
    tt.integrate(cfg, got, depth, rgb, K, pose)
    tt.integrate_plain(cfg, want, depth, rgb, K, pose)
    for f in ("tsdf", "weight", "color"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert not torch.equal(got.weight, vol.weight)
    zbuf = tt.splat_zbuf(cfg, got, K, render, H, W)
    plain = tt.splat_zbuf_plain(cfg, got, K, render, H, W)
    assert torch.equal(zbuf, plain)
    assert int(torch.isfinite(plain).sum()) > (500 if scene == "turn80"
                                               else 0.04 * H * W)
    finite = torch.where(torch.isfinite(plain), plain,
                         torch.zeros_like(plain)).reshape(H, W)
    filled = tt.fill_holes_plain(finite, 2)
    assert torch.equal(tt._fill_holes(zbuf.reshape(H, W), 2, from_zbuf=True),
                       filled)
    assert torch.equal(tt._fill_holes(finite, 2), filled)
    assert torch.equal(tt.render_depth_splat(cfg, got, K, render, H, W),
                       filled)
    assert [tt.integrate.launches, tt.splat_zbuf.launches,
            tt._fill_holes.launches] == [counts[0] + 1, counts[1] + 2,
                                         counts[2] + 6]


def test_tsdf_fill_kernel_sparse_and_rounds(dev):
    """The fill kernel on a sparse map with holes of every size, 1-4
    rounds, and on a z-buffer with negative, zero and inf pixels."""
    from tandem_tpu_torch.mapping import tsdf as tt
    gen = torch.Generator(device=dev).manual_seed(3)
    keep = torch.rand((97, 131), generator=gen, device=dev) < 0.1
    depth = torch.where(keep, 0.5 + 3 * torch.rand(
        (97, 131), generator=gen, device=dev), torch.zeros((), device=dev))
    for rounds in (1, 2, 3, 4):
        assert torch.equal(tt._fill_holes(depth, rounds),
                           tt.fill_holes_plain(depth, rounds))
    zbuf = depth.clone()
    zbuf[~keep] = float("inf")
    zbuf[:3, :5] = -1.0
    assert torch.equal(
        tt._fill_holes(zbuf, 2, from_zbuf=True),
        tt.fill_holes_plain(torch.where(torch.isfinite(zbuf), zbuf,
                                        torch.zeros_like(zbuf)), 2))


class _CardDepthRunner:
    """A stand-in MVSNet runner that hands back prescribed depth maps on
    its device (the backend's map path without a network)."""
    view_num = 7

    def __init__(self, depths, device):
        self.depths = list(depths)
        self.device = device
        self._out = None

    def call_async(self, bgrs, cam_to_worlds, K, depth_min, depth_max,
                   discard_percentage=10.0):
        self._out = self.depths.pop(0)

    def get_result(self, device=False):
        return {"depth": torch.from_numpy(self._out).to(self.device),
                "confidence": None}

    def device_ready(self):
        return True


def _backend_run(device, timer=None, cpu_route: bool = False):
    """Five calls (four fused keyframes) of a backend at 120x160: a wall, the
    camera turned 90 degrees onto a patch (most of the map leaves the
    frustum), then back, moved. The rotations are exact (0 and +-1), so the
    CPU's and the card's matrix products agree bit for bit. ``cpu_route``
    sends a card backend down the CPU's route. Returns the backend and the
    rendered depth of each fused call."""
    from tandem_tpu_torch.mapping import tsdf as tt
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    H, W = 120, 160
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    wall = (1.537 + 0.2 * np.sin(u * 0.05) * np.cos(v * 0.07)).astype(
        np.float32)
    patch = np.zeros((H, W), np.float32)
    patch[40:70, 60:100] = 1.2
    turn = np.eye(4, dtype=np.float32)
    turn[:3, :3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
    moved = np.eye(4, dtype=np.float32)
    moved[:3, 3] = (0.05, -0.03, 0.02)
    kfs = [(wall, np.eye(4, dtype=np.float32)), (patch, turn), (wall, moved),
           (wall, np.eye(4, dtype=np.float32))]
    K = np.array([[140.0, 0, (W - 1) / 2], [0, 140.0, (H - 1) / 2],
                  [0, 0, 1]], np.float32)
    img = np.dstack([u % 256, v % 256, (u + v) % 256]).astype(np.uint8)
    backend = TandemBackend(
        _CardDepthRunner([d for d, _ in kfs] + [wall], device),
        tt.TsdfConfig(voxel_size=0.02, table_dim=64, pool_size=4096,
                      truncation=0.08, max_depth=8.0), K, H, W,
        mesh_extraction_freq=0, timer=timer)
    backend.on_card = backend.on_card and not cpu_route
    renders = []
    for i, (_, p) in enumerate(kfs + [kfs[0]]):
        backend.call([img] * 7, [p] * 7, 0.5, 6.0, kfs[min(i, 3)][1])
        if i:
            renders.append(backend.get_tracking_depth_map()["depth"])
    return backend, renders


def test_card_backend_equals_cpu_route(dev, monkeypatch):
    """Four keyframes through the card's route (the kernels) against the
    CPU route (culled integrate, axis-culled splat, plain fill) run on the
    card in plain torch: the volumes and the renders equal bit for bit. The
    card's route reads the host once a call, samples ``fusion_kernels`` 1 a
    keyframe and launches integrate and the splat once and the fill twice a
    keyframe; ``FusedScans`` records each scan. Against the CPU backend:
    the same blocks and weights, the sdf and the renders within a few
    float32 ulps (the CPU's torch ops round the scan's ray norms
    differently from the card's by an ulp on ~0.6% of the pixels)."""
    from collections import deque

    from benchmark.traffic.common import FusedScans, Patches
    from tandem_tpu_torch.mapping import tsdf as tt
    from tandem_tpu_torch.pipeline import backend as backend_module
    from tandem_tpu_torch.utils import timer as tm
    log = deque(maxlen=tm.LOG_ENTRIES)
    monkeypatch.setattr(tm, "LOG", log)
    fns = (tt.integrate, tt.splat_zbuf, tt._fill_holes)
    before = [fn.launches for fn in fns]
    patches = Patches()
    scans = FusedScans(patches)
    try:
        card, card_renders = _backend_run(dev, tm.Timer())
    finally:
        patches.undo()
    assert [fn.launches - n for fn, n in zip(fns, before)] == [4, 4, 8]
    assert len(scans.scans) == 4
    samples = [e for e in log if isinstance(e, tm.Sample)]
    assert [s.value for s in samples if s.name == "fusion_kernels"] == [1] * 4
    assert sum(s.value for s in samples
               if s.name == "fusion_host_reads") == 4
    names = {s.name for s in log if isinstance(s, tm.Span)}
    assert "fusion_cull" not in names and "fusion_read" in names
    assert card.last_fuse["n_visible"] is None

    def plain_fill(depth, rounds=2, from_zbuf=False):
        if from_zbuf:
            depth = torch.where(torch.isfinite(depth), depth,
                                torch.zeros_like(depth))
        return tt.fill_holes_plain(depth, rounds)

    with monkeypatch.context() as m:
        m.setattr(backend_module, "integrate", tt.integrate_plain)
        m.setattr(tt, "_fill_holes", plain_fill)
        launches = [fn.launches for fn in fns]
        torch_route, torch_renders = _backend_run(dev, cpu_route=True)
        assert [fn.launches for fn in fns] == launches
    assert torch_route.last_fuse["n_visible"] is not None
    for f in ("page_table", "block_coords", "tsdf", "weight", "color"):
        assert torch.equal(getattr(card.volume, f),
                           getattr(torch_route.volume, f)), f
    for a, b in zip(card_renders, torch_renders):
        assert torch.equal(a, b)
    assert (card_renders[-1] > 0).float().mean() > 0.5

    cpu, cpu_renders = _backend_run(torch.device("cpu"))
    for f in ("page_table", "block_coords", "weight"):
        assert torch.equal(getattr(card.volume, f).cpu(),
                           getattr(cpu.volume, f)), f
    for f in ("tsdf", "color"):
        gap = (getattr(card.volume, f).cpu() - getattr(cpu.volume, f)).abs()
        assert float(gap.max()) <= (1e-5 if f == "tsdf" else 1e-3), f
    for a, b in zip(card_renders, cpu_renders):
        assert torch.equal(a.cpu() > 0, b > 0)
        assert float((a.cpu() - b).abs().max()) <= 1e-5


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
    """The dr_debug_example CLI on the card for the first 20 frames of
    tests/fixtures/replica_traj (its default --limit): the printed lines,
    the render PNGs, a non-empty mesh, and every render within the
    GT-depth bars (hits > 0.8, median < 2 voxels)."""
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
        "--depth-scale", "0.0002"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = cli.main(args)
    lines = buf.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        f"frame {i}" for i in range(args.limit)] + ["mesh"]
    assert res["volume"].tsdf.is_cuda and res["vertices"] > 0
    assert len(res["renders"]) == args.limit
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


def _grad_case(dev, stage: str, dtype, seed: int = 0, B: int = 1):
    """A plane sweep at an abl04 stage shape: grad_out, ref->src matrices
    and depths. Item 0's matrix moves the camera sideways and forward (part
    of the sweep falls outside the image) over depths of 0.2-6 m with a
    band behind the source camera; item 1 (B = 2, as training gives it)
    turns the camera and moves it back, over depths of 0.5-4 m."""
    D, Hs, Ws, C = STAGE_SHAPES[stage]
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
@pytest.mark.parametrize("stage", list(STAGE_SHAPES))
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
    D0, Hs, Ws, C0 = STAGE_SHAPES[stage]
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


def test_train_cli_epoch_and_resume_on_card(dev, tmp_path):
    """tandem_train (abl04, 640x480, B = 2, f32) on replica_traj: one epoch
    of 7 steps, then a resume with --pretrained to step 14; finite losses,
    18 launches of each sample kernel a step."""
    first = _train_cli(dev, tmp_path / "epoch")
    r = first["res"]
    _require_step_launches("train epoch", first["counts"], r["steps"], 18)
    ckpt = r["checkpoints"][-1]
    assert r["steps"] == 7 and ckpt.endswith("step_00000007")
    assert np.isfinite(r["losses"]).all()
    again = _train_cli(dev, tmp_path / "resume", ckpt)
    r2 = again["res"]
    _require_step_launches("train resume", again["counts"], r2["steps"], 18)
    assert r2["checkpoints"][-1].endswith("step_00000014")
    assert np.isfinite(r2["losses"]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_learns_on_card(dev, dtype):
    """tests/test_train_learns.py's curve on the card at abl04 640x480
    (B = 2, replica_traj tuples 0 and 7): f32 over CURVE_STEPS steps, the
    last 5 losses' mean under half the first 5's; bf16 over BF16_STEPS,
    falling. 18 launches of each sample kernel a step; the first step's
    backward calls match the plain gradient."""
    from tandem_tpu_torch import config as pcfg
    from tandem_tpu_torch.data.replica import MVSDataset, collate
    from tandem_tpu_torch.train import trainer as pt
    config = pcfg.default()
    pcfg.merge_from_file(config, str(ABL04_CONFIG))
    config["TRAIN.COMPUTE_DTYPE"] = dtype
    ds = MVSDataset(str(TRAIN_ROOT), "val", height=480, width=640)
    batch = pt.batch_to_device(collate([ds[0], ds[7]]), dev)
    steps = CURVE_STEPS if dtype == "float32" else BF16_STEPS
    model, state = pt.create_train_state(
        config, torch.Generator().manual_seed(0), 200, device=dev)
    step = pt.make_train_step(model, config)
    reset_counts()
    state, m, calls = _recorded_step(step, state, batch)
    assert len(calls) == 18
    for gout, mat, depth, _, acc in calls:
        _assert_grad_matches_plain(acc, gout, mat, depth)
    del calls
    losses = [float(m["loss"])]
    for _ in range(steps - 1):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    _require_step_launches("train curve", read_counts(), steps, 18)
    assert np.isfinite(losses).all(), losses
    if dtype == "float32":
        assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5]), losses
    else:
        assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_runtime_preset_on_card(dev, tmp_path):
    """tandem_dataset preset=runtime (preload=1, dense tracking) with the
    trained unit on the card: the synthetic 640x480 sequence of
    ``torch_cases.write_runtime_sequence``, 24 frames. Every frame
    tracked, the prefetch-free route (preload) timed in read_frame,
    keyframes made, the backend launched K1's filter and the plane-sweep
    sample, and the tracker K6 and track_lm."""
    import os

    from tandem_tpu_torch.cli import tandem_dataset
    from tandem_tpu_torch.ops.bilinear_sample import warp_sample
    from tandem_tpu_torch.ops.edge_kth import edge_filter
    from tandem_tpu_torch.ops.track_lm import lm_level
    from tandem_tpu_torch.ops.track_reduce import track_reduce
    write_runtime_sequence(tmp_path / "seq", n=24)
    unit = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "exported", "tandem")
    before = (edge_filter.calls, warp_sample.launches, track_reduce.launches,
              lm_level.launches)
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
    assert track_reduce.launches > before[2] and lm_level.launches > before[3]
    assert (tmp_path / "out" / "result.txt").read_text().count("\n") == 24


def test_runtime_preset_full_sequence_on_card(dev, tmp_path):
    """tandem_dataset preset=runtime with the trained unit at the preset's
    own settings on bench_runtime.py's RUNTIME_FRAMES-frame 640x480
    sequence: at least RUNTIME_MIN_POSES poses, not lost, the backend
    called, K1's filter (its launches a call), the plane-sweep sample, K6
    and track_lm launched."""
    from tandem_tpu_torch.cli import tandem_dataset
    write_runtime_sequence(tmp_path / "seq", n=RUNTIME_FRAMES)
    reset_counts()
    res = tandem_dataset.main(
        ["preset=runtime", f"files={tmp_path / 'seq' / 'images'}",
         f"calib={tmp_path / 'seq' / 'camera.txt'}",
         f"result_folder={tmp_path / 'out'}", f"mvsnet_folder={UNIT}",
         "dr_timing=1"], device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    n_poses = len((tmp_path / "out" / "result.txt").read_text()
                  .splitlines())
    assert n_poses >= RUNTIME_MIN_POSES and not res["fs"].is_lost, (
        n_poses, res["fs"].is_lost)
    assert res["backend"].call_num >= 1
    require_edge_filter("runtime", counts["edge_kth"], edge_calls(), 1)
    require_launched("runtime", counts,
                     ("bilinear_sample", "track_lm", "track_reduce"))


def _require_slam_run(path, r, mvsnet: bool):
    """A ``torch_cases._slam_run`` on the trajectory fixture:
    tests/test_vo_ate.py's frame and ATE bars, the tracker's kernels; with
    the unit, the backend, the edge filter and the sample."""
    assert r["pairs"] >= SLAM_MIN_FRAMES, (path, r["pairs"])
    assert r["ate"]["rmse"] < SLAM_ATE_BOUND, (path, r["ate"])
    require_launched(path, r["counts"], ("track_reduce", "track_lm"))
    if mvsnet:
        assert r["res"]["backend"].call_num >= 1, path
        require_edge_filter(path, r["counts"]["edge_kth"], r["edge_calls"], 1)
        require_launched(path, r["counts"], ("bilinear_sample",))


def test_slam_on_card(dev, tmp_path):
    """tandem_dataset on replica_traj's 64 frames: VO only, then with the
    trained unit twice (the prefetcher, then preload=1), each within
    ``_require_slam_run``'s bars; the full runs write a mesh and the same
    result.txt."""
    runs = {}
    for tag, mvsnet, preload in (("vo", False, False), ("full", True, False),
                                 ("full_again", True, True)):
        runs[tag] = r = _slam_run(dev, tmp_path / tag, mvsnet,
                                  preload=preload)
        _require_slam_run(f"slam {tag}", r, mvsnet)
        if mvsnet:
            assert len(r["res"]["backend"].last_mesh[0]) > 0
            assert (tmp_path / tag / "mesh.obj").stat().st_size > 0
    assert runs["full"]["digest"] == runs["full_again"]["digest"]


def test_exported_units_on_card(dev, tmp_path, capsys):
    """tandem_export on the card: the trained unit at 640x480 replays the
    golden pack through a fresh load of model.pt2 within GOLDEN_TOL (18
    sample launches, one edge filter); a weightless unit exported at
    256x192 serves tandem_dataset on replica_traj with its boot
    self-check, within ``_require_slam_run``'s bars."""
    import json
    import shutil

    from tandem_tpu_torch.cli import tandem_export as te
    cfg = json.loads((UNIT / "model_config.json").read_text())
    pack = np.load(UNIT / "sample_inputs.npz")
    _, V, _, Hh, Ww = pack["image"].shape
    args = ["--ckpt", str(UNIT / "model_variables.pkl"), "--view-num",
            str(V), "--depth-num", ",".join(str(d) for d in cfg["depth_num"]),
            "--discard-percentage", str(float(pack["discard_percentage"])),
            "--device", "cuda"]
    te.main(te.parser.parse_args(args + [
        "--out-dir", str(tmp_path / "unit"), "--width", str(Ww), "--height",
        str(Hh)]))
    program, _ = te.load_program(str(tmp_path / "unit"))
    x = te.program_inputs(pack, float(pack["discard_percentage"]), dev)
    reset_counts()
    with torch.no_grad():
        outs = program.module()(*x)
    torch.cuda.synchronize()
    counts = read_counts()
    require_edge_filter("export replay", counts["edge_kth"], edge_calls(), 1)
    assert counts["bilinear_sample"] == 3 * (V - 1)
    require_not_launched("export replay", counts,
                         ("bilinear_index", "corner_blend"))
    worst = max(float(np.abs(pack["out." + k] - v.float().cpu().numpy())
                      .mean()) for k, v in zip(te.STAGE3, outs))
    assert worst < GOLDEN_TOL, worst

    small = tmp_path / "small"
    te.main(te.parser.parse_args(args + [
        "--out-dir", str(small), "--width", "256", "--height", "192",
        "--data-root", str(FIXTURE.parent)]))
    unit = tmp_path / "weightless"
    unit.mkdir()
    for name in (te.PROGRAM, te.PROGRAM_INFO, "model_config.json",
                 "sample_inputs.npz"):
        shutil.copy(small / name, unit / name)
    capsys.readouterr()
    r = _slam_run(dev, tmp_path / "slam", True, unit=unit)
    assert "MVSNet golden self-check" in capsys.readouterr().out
    _require_slam_run("export slam", r, True)


def test_decoder_on_the_card_host(dev):
    """The C PNG decoder as the card's machine builds it, bit-equal to
    data/replica.decode_png on a fixture frame and on a 640x480 frame whose
    rows cycle through Paeth, Sub, Up and Average."""
    from tandem_tpu_torch.data.replica import decode_png
    from tandem_tpu_torch.native_bridge import decode_png_native
    g = _runtime_frames(1, 480, 640)[0][0]
    for data in ((FIXTURE / "images" / "000000.png").read_bytes(),
                 _png_filtered(np.repeat(g[..., None], 3, -1))):
        a, b = decode_png_native(data), decode_png(data)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_rgbd_on_card(dev, tmp_path):
    """FullSystem(rgbd=True) on replica_traj's frames and sensor depths:
    VO only on 64 frames within RGBD_ATE_BOUND (SE(3)), dvo's pose kept on
    RGBD_DVO_POSES +- RGBD_DVO_POSES_SLACK frames; with the trained unit
    on 48, the backend called and result.txt equal to the VO run's first
    48 lines (the sensor depth feeds the tracker). Launches as named."""
    runs = {}
    for tag, unit, frames in (("vo", False, 64), ("full", True, 48)):
        (tmp_path / tag).mkdir()
        runs[tag] = r = _rgbd_run(dev, tmp_path / tag, unit, frames=frames)
        fs = r["fs"]
        dvo = fs.n_dvo_frames - fs.n_dvo_fallbacks
        assert dvo >= 1, tag
        require_launched(f"rgbd {tag}", r["counts"], ("track_reduce",),
                         at_least=dvo)
        require_launched(f"rgbd {tag}", r["counts"], ("track_lm",))
        if unit:
            assert r["backend"].call_num >= 1
            require_edge_filter(f"rgbd {tag}", r["counts"]["edge_kth"],
                                r["edge_calls"], 1)
            require_launched(f"rgbd {tag}", r["counts"], ("bilinear_sample",))
    vo = runs["vo"]
    assert vo["pairs"] >= SLAM_MIN_FRAMES
    assert vo["ate"]["rmse"] <= RGBD_ATE_BOUND, vo["ate"]
    assert abs(vo["fs"].n_dvo_poses - RGBD_DVO_POSES) <= RGBD_DVO_POSES_SLACK
    assert runs["full"]["digest"] == vo["digest_48"]


def test_demo_with_the_unit_on_card(dev, tmp_path):
    """tandem_demo replay= record= with the trained unit over replica_traj's
    first DEMO_FRAMES frames; the recording replayed through tandem_dataset
    with its debug sinks gives the demo's poses and fills every sink."""
    import os
    import shutil

    from tandem_tpu_torch.cli import tandem_dataset, tandem_demo
    src = tmp_path / "src"
    src.mkdir()
    for i in range(DEMO_FRAMES):
        shutil.copy(FIXTURE / "images" / f"{i:06d}.png", src)
    rec, demo, replay = (tmp_path / d for d in ("rec", "demo", "replay"))
    reset_counts()
    res = tandem_demo.main([f"replay={src}",
                            f"calib={FIXTURE / 'camera_dso.txt'}",
                            f"record={rec}", f"result_folder={demo}",
                            f"mvsnet_folder={UNIT}", "demo_secs=600"],
                           device=dev)
    assert res["frames"] == DEMO_FRAMES and res["fs"].device.type == "cuda"
    assert len(os.listdir(rec / "images")) == DEMO_FRAMES
    assert len((rec / "times.txt").read_text().splitlines()) == DEMO_FRAMES
    assert (rec / "camera.txt").exists()
    require_launched("demo", read_counts(), ("track_lm", "track_reduce"))
    reset_counts()
    tandem_dataset.main([f"files={rec / 'images'}",
                         f"calib={rec / 'camera.txt'}",
                         f"result_folder={replay}", f"mvsnet_folder={UNIT}",
                         "desired_immature_density=512", "log_stuff=1",
                         "debug_save_depth_images=1", "save_dr_video=1",
                         "viewer3d=1"], device=dev)
    require_launched("demo replay", read_counts(),
                     ("bilinear_sample", "track_lm", "track_reduce"))
    assert ((replay / "poses_dso.txt").read_bytes()
            == (demo / "poses_dso.txt").read_bytes())
    cols = [[ln.split()[1:] for ln in (d / "result.txt").read_text()
             .splitlines()] for d in (demo, replay)]
    assert cols[0] == cols[1]
    for d in ("logs", "depths", "dr_video", "view3d"):
        assert os.listdir(replay / d), d


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_view_sharded_runner_golden_on_card(dev, dtype):
    """The trained unit's view-sharded runner over [cuda:0] * n (n = 2, 4)
    against the eager runner on the golden window at 640x480, within the
    SHARD_* bars (f32 also the golden MAE under GOLDEN_TOL); 18 sample
    launches and one edge filter a call."""
    import json

    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
    eager, pack = load_runner(dev, dtype)
    want = _runner_outputs(eager, pack)
    if dtype == torch.float32:
        base = _golden_forward(eager, pack, dev).stage3.depth_dense
        nudged = _golden_forward(eager, pack, dev,
                                 1 + 2 ** -23).stage3.depth_dense
        bar = max(SHARD_DEPTH_TOL[1],
                  SHARD_FLOOR_X * float((nudged - base).abs().max()))
    cfg = json.loads((UNIT / "model_config.json").read_text())
    variables = load_variables(UNIT / "model_variables.pkl")
    for n in (2, 4):
        runner = MvsnetRunner(CvaMVSNet(**cfg, dtype=dtype), variables,
                              eager.height, eager.width,
                              view_num=eager.view_num, devices=[dev] * n)
        reset_counts()
        got = _runner_outputs(runner, pack)
        counts = read_counts()
        assert counts["bilinear_sample"] == 18, n
        require_edge_filter(f"view shards n={n}", counts["edge_kth"],
                            edge_calls(), 1)
        d, d0 = got["depth_dense"], want["depth_dense"]
        if dtype == torch.bfloat16:
            assert np.abs(d - d0).mean() / np.abs(d0).mean() < SHARD_BF16_REL
            continue
        kept, kept0 = got["depth"] > 0, want["depth"] > 0
        both = kept & kept0
        assert max(float(np.abs(d - d0).max()), float(np.abs(
            got["depth"][both] - want["depth"][both]).max())) <= bar, n
        c, c0 = got["confidence_dense"], want["confidence_dense"]
        assert (np.abs(c - c0) > SHARD_CONF_TOL[1] + SHARD_CONF_TOL[0]
                * np.abs(c0)).mean() <= SHARD_FLIP_SHARE, n
        assert (kept != kept0).mean() <= SHARD_FLIP_SHARE, n
        assert max(float(np.abs(got[k] - pack[f"out.stage3.{k}"]).mean())
                   for k in ("depth", "confidence", "depth_dense",
                             "confidence_dense")) < GOLDEN_TOL, n


def test_data_parallel_ranks_share_the_card(dev, tmp_path):
    """2 gloo ranks on cuda:0 (replica_traj tuples 0, 3, 7, 10 at 64x64,
    planes (8, 8, 4), 2 rows a rank, 2 steps) against one process at
    world_size 2 on the global batch on the card: losses within 5e-3
    relative, equal parameters on both ranks, and each rank's steps
    launch the sample and its backward kernel 18 times a step."""
    from tandem_tpu_torch import config as pcfg
    from tandem_tpu_torch.data.replica import MVSDataset, collate
    config = pcfg.default()
    config.update({"MODEL.DEPTH_NUM": (8, 8, 4), "DATA.IMG_HEIGHT": 64,
                   "DATA.IMG_WIDTH": 64})
    root = os.path.join(os.path.dirname(__file__), "fixtures",
                        "replica_traj")
    items = collate([MVSDataset(root, "val", height=64, width=64)[i]
                     for i in (0, 3, 7, 10)])
    _ranks_against_one_process(dev, tmp_path, config, items, 2, 5e-3, 300)


def test_data_parallel_ranks_at_640x480_on_card(dev, tmp_path):
    """The same at abl04's 640x480 (its 48/4/4 planes): 2 gloo ranks on
    cuda:0 with 2 of the trajectory fixture's DP_TUPLES each, DP_STEPS
    steps, against one process at world_size 2 on all four: losses within
    DP_RTOL, equal parameters on both ranks, 18 launches of the sample and
    of its backward kernel a step."""
    from tandem_tpu_torch import config as pcfg
    from tandem_tpu_torch.data.replica import MVSDataset, collate
    config = pcfg.default()
    pcfg.merge_from_file(config, str(ABL04_CONFIG))
    ds = MVSDataset(str(TRAIN_ROOT), "val", height=DP_SIZE[0],
                    width=DP_SIZE[1])
    items = collate([ds[i] for i in DP_TUPLES])
    _ranks_against_one_process(dev, tmp_path, config, items, DP_STEPS,
                               DP_RTOL, 600)


def _ranks_against_one_process(dev, tmp_path, config, items, steps: int,
                               rtol: float, timeout: float):
    from tandem_tpu_torch.parallel.dryrun import (run_ranks, train_rank,
                                                  train_steps)
    from tandem_tpu_torch.train import trainer as pt
    batch = {k: items[k] for k in pt.BATCH_KEYS}
    one = train_steps(config, batch, steps, dev, world_size=2)
    torch.cuda.empty_cache()
    ranks = run_ranks(train_rank, 2, tmp_path,
                      (config, batch, steps, "cuda:0", "gloo"),
                      timeout=timeout)
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"],
                               rtol=rtol)
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n
    for r in ranks:
        assert r["launches"] == {"bilinear_sample": 18 * steps,
                                 "warp_sample_grad": 18 * steps}


def test_train_cli_mesh_on_card(dev, tmp_path):
    """tandem_train TRAIN.DEVICE mesh on the card: one rank a card
    (spawned, NCCL), 2 steps at 64x96, one checkpoint, finite losses."""
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


def test_train_cli_mesh_at_640x480_on_card(dev, tmp_path):
    """The same with the abl04 config at its own 640x480, B = 2."""
    from tandem_tpu_torch.cli import tandem_train
    res = tandem_train.main(tandem_train.parser.parse_intermixed_args([
        str(tmp_path / "mesh"), "--config", str(ABL04_CONFIG),
        "DATA.ROOT_DIR", str(TRAIN_ROOT), "TRAIN.EPOCHS", "1",
        "TRAIN.MAX_STEPS", "2", "IO.LOG_INTERVAL", "1", "TRAIN.DEVICE",
        "mesh"]))
    assert res["steps"] == 2 and np.isfinite(res["losses"]).all()
    assert os.listdir(tmp_path / "mesh" / "ckpt") == ["step_00000002"]


@pytest.mark.parametrize("depth_num", ["48,32,8", "48,4,4"])
def test_eval_on_card(dev, tmp_path, depth_num):
    """The port's tandem_eval CLI on tests/fixtures/replica_mini with the
    trained 512x320 unit, tuple 0, at both architectures: each stage's
    abs_rel within EVAL_TOL of tests/test_eval_fixture.py's reference, the
    forward sample launched."""
    import shutil

    from tandem_tpu_torch.cli import tandem_eval
    ckpt = tmp_path / f"trained_{depth_num.replace(',', '_')}.pkl"
    shutil.copy(EVAL_UNIT / "model_variables.pkl", ckpt)
    reset_counts()
    errors = tandem_eval.main(tandem_eval.parser.parse_args([
        "--ckpt", str(ckpt), "--data-root", str(EVAL_ROOT), "--width", "512",
        "--height", "320", "--limit", "1", "--depth-num", depth_num]))
    torch.cuda.synchronize()
    require_launched(f"eval {depth_num}", read_counts(), ("bilinear_sample",))
    for stage, ref in REF_ABS_REL[depth_num].items():
        assert abs(errors[stage]["abs_rel"] - ref) < EVAL_TOL, (stage, errors)
