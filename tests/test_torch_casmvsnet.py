"""CasMVSNet, the cascade without view aggregation (the variance cost
volume), through the port: against the benchmark's plain reference
(``benchmark/reference/casmvsnet.py``) on seeded weights at small sizes on
the CPU; the variance step ``ops/bilinear_sample.warp_variance`` against
the eager accumulation it replaced; the seeded unit the benchmark writes;
the runner's counter; and, on the card (``-m cuda``), the kernel against
its plain version and the runner's CUDA graph against its eager forward
at CasMVSNet's DTU test size (5 views, 1152 x 864). This file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_casmvsnet.py
"""

import json
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference.casmvsnet import PlainCasMVSNet
from benchmark.traffic import common, scene, weights
from benchmark.traffic.mapping_seeded import (calibration_windows,
                                              variance_reference, write_unit)
from tandem_tpu_torch.cli.golden import load_model_config
from tandem_tpu_torch.models.convert import flax_to_state_dict, load_variables
from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet, Stage3Forward
from tandem_tpu_torch.ops import bilinear_sample as bs
from tandem_tpu_torch.ops.warp import (plane_sweep_variance, plane_sweep_warp,
                                       ref_pixel_to_world, ref_to_src_matrix)
from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
from tandem_tpu_torch.utils import timer as tm

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" /
                     "casmvsnet_dtu_1152x864.json").read_text())
TRAFFIC = json.loads((ROOT / "benchmark" / "workloads" /
                      "kf_stream_seeded.json").read_text())
PATH = TRAFFIC["path"]
MINI = ROOT / "tests" / "fixtures" / "replica_mini"
W, H = 96, 64
SEED = 2 ** 31 + 19


@pytest.fixture(autouse=True)
def one_thread():
    """Six pytest workers share the CPU: an OpenMP pool a worker starves
    the others (the 48/32/8 cascade here runs ~50x slower with one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_config(depth_num):
    return dict(CONFIG["model"], depth_num=list(depth_num))


def _window(V, width=W, height=H, device="cpu"):
    """A V-view window of the path at width x height, as the mapping
    driver records a call (the second newest view is the reference)."""
    cam = scene.Camera(width, height, 675.0 * width / 1152,
                       675.0 * width / 1152)
    frames = [8 * j for j in range(V)]
    bgrs, _, _ = scene.render_frames(frames, PATH, cam,
                                     scene.texture_offset(16), device)
    return {"bgrs": list(bgrs), "K": cam.K, "dmin": 0.01, "dmax": 6.0,
            "discard": 10.0,
            "c2w": [scene.path_pose(f, PATH).astype(np.float32)
                    for f in frames]}


def _unit(tmp_path, model, seed=SEED, V=0, width=W, height=H,
          device="cpu"):
    """A seeded unit; with ``V``, its BatchNorm statistics calibrated on
    the stream's V-view windows at width x height, as the benchmark's
    driver writes it."""
    unit = tmp_path / f"unit_{seed}"
    unit.mkdir()
    windows = calibration_windows(
        dict(CONFIG, views=V, image={"width": width, "height": height,
                                     "fx": 675.0 * width / 1152,
                                     "fy": 675.0 * width / 1152}),
        TRAFFIC, device) if V else ()
    write_unit(unit, model, seed, device, windows)
    return unit


def _runner(unit, V, device="cpu", width=W, height=H):
    model = CvaMVSNet(**load_model_config(str(unit)))
    return MvsnetRunner(model, load_variables(str(unit /
                                                  "model_variables.pkl")),
                        height, width, view_num=V, device=device)


def _stages(unit, model, V, rec):
    """Every stage of the eager model and of the plain variance cascade on
    one window, and the runner's filtered stage 3 against the reference's:
    ({stage: (depth, confidence, reference depth, reference confidence)},
    the mvs_gaps of the filtered maps)."""
    inputs = common.reference_inputs(rec, "cpu")
    ref = variance_reference(Path("/"), {"unit": str(unit), "model": model},
                             "cpu")
    stages = ref.cascade(*inputs[:5])
    runner = _runner(unit, V)
    args = runner.pack_inputs(rec["bgrs"], rec["c2w"], rec["K"])
    dev = runner._device_inputs(*args, rec["dmin"], rec["dmax"],
                                rec["discard"])
    out = runner.model(dev[0], dev[1:4], *dev[4:7])
    got = {name: (getattr(out, name).depth, getattr(out, name).confidence,
                  *stages[name]) for name in stages}
    filtered = runner._run(*args, rec["dmin"], rec["dmax"], rec["discard"])
    want = ref(*inputs)
    return got, common.mvs_gaps(filtered[0], filtered[1], want[0], want[1])


# The program's depth against the reference's, as a share of the spread of
# the reference's depth over the image; its confidence; and the share of
# pixels whose confidence may differ by more than that (see below).
DEPTH_SPREAD_TOL = 2e-4
CONF_TOL = 1e-4
CONF_FLIP_SHARE = 5e-3


@pytest.mark.parametrize("V", [3, 5])
@pytest.mark.parametrize("depth_num", [(48, 32, 8), (16, 8, 4)])
def test_program_equals_the_plain_reference(tmp_path, V, depth_num):
    """Seeded weights, their BatchNorm statistics calibrated on the scene
    as the benchmark's driver does, at 96 x 64: every stage of the eager
    model, and the runner's filtered stage 3, against the plain variance
    cascade in float32. Calibrated, the depth follows the cost volume: its
    spread over the image (the standard deviation of the reference's
    depth) is 1-8 of the stage's plane intervals here, and at least half
    of one is asked for (at the initial statistics it is ~1e-4 of one).
    The two sum the views in other orders (the reference view first there,
    last here) and sample with other arithmetic (``grid_sample`` against
    the plain sample), so they agree to float32 rounding carried through
    ~20 layers: every depth within 2e-4 of the spread (up to 5.7e-5 is
    read). The confidence, the sum of four plane probabilities at the
    expected plane's index, agrees within 1e-4 (up to 2.6e-5 is read)
    except where a rounding-level change moves that index across a plane,
    on at most 0.5% of the pixels. The edge filter's threshold, an exact
    rank of the edge values, flips at most 0.5% of the pixels of the
    filtered maps."""
    model = _model_config(depth_num)
    unit = _unit(tmp_path, model, V=V)
    got, gaps = _stages(unit, model, V, _window(V))
    base = 6.0 / (depth_num[0] - 1)
    for i, (name, (depth, conf, rdepth, rconf)) in enumerate(got.items()):
        spread = float(rdepth.std())
        assert spread > 0.5 * base * model["depth_interval_ratio"][i], name
        gap = float((depth - rdepth).abs().max())
        assert gap < DEPTH_SPREAD_TOL * spread, (name, gap / spread)
        off = (conf - rconf).abs() > CONF_TOL
        assert float(off.float().mean()) <= CONF_FLIP_SHARE, name
    assert gaps["depth_rel_gap"] < 1e-5 and gaps["conf_gap"] < 1e-5, gaps
    assert gaps["mask_flip_share"] <= 5e-3, gaps


def test_a_dropped_source_view_is_seen(tmp_path, monkeypatch):
    """A cost volume that leaves out the last source view of each stage
    (its samples never added to the sums) moves the calibrated cascade's
    depth far past the tolerance above, and the filtered maps' gaps past
    the benchmark cell's limits: the comparison sees the cost volume."""
    from tandem_tpu_torch.ops import warp
    model = CONFIG["model"]
    V = 5
    unit = _unit(tmp_path, model, V=V)
    rec = _window(V)
    sound, _ = _stages(unit, model, V, rec)
    real, calls = warp.warp_variance, [0]

    def dropping(img, mat, depth, sums=None, *a):
        calls[0] += 1
        if calls[0] % (V - 1) == 0:      # the stage's last source view
            return sums
        return real(img, mat, depth, sums, *a)
    monkeypatch.setattr(warp, "warp_variance", dropping)
    broken, gaps = _stages(unit, model, V, rec)
    assert calls[0] >= 3 * (V - 1)
    depth, _, rdepth, _ = broken["stage3"]
    assert float((depth - rdepth).abs().max()) \
        > 100 * DEPTH_SPREAD_TOL * float(rdepth.std())
    limits = json.loads((ROOT / "benchmark" / "limits" /
                         "mapping.casmvsnet_dtu_1152x864.kf_stream_seeded"
                         ".json").read_text())
    assert all(gaps[k] > limits[k] for k in ("depth_rel_gap", "conf_gap")), \
        gaps


def test_reference_refuses_the_gated_cascade_and_fp8():
    with pytest.raises(ValueError):
        PlainCasMVSNet({}, dict(CONFIG["model"], view_aggregation=True))
    with pytest.raises(ValueError):
        PlainCasMVSNet({}, CONFIG["model"], "fp8")


def _sweep(dtype, V=5, B=1, D=6, h=20, w=28, C=8, seed=0):
    """Source features, ref -> src matrices (one a source view) and depth
    hypotheses of a small plane sweep whose samples leave the image at
    the borders and fall behind some source cameras."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(B, V, h, w, C, generator=g).to(dtype)
    K = torch.tensor([[[20.0, 0, 13.5], [0, 20.0, 9.5], [0, 0, 1]]])
    c2w = torch.eye(4).repeat(B, V, 1, 1)
    c2w[:, :, 0, 3] = 0.3 * torch.arange(V) - 0.6
    c2w[:, :, 2, 3] = 0.4 * torch.arange(V) - 0.8
    depth = (torch.rand(B, D, h, w, generator=g) * 4 + 0.2)
    return feats, K.repeat(B, 1, 1), c2w, depth


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variance_step_equals_the_eager_accumulation(dtype):
    """``warp_variance``'s plain version (its CPU implementation) gives the
    eager cascade's sums bit for bit: each view's warped volume and its
    square written by the first view and added by the later ones; and the
    stage's cost volume from them is the eager one."""
    feats, K, c2w, depth = _sweep(dtype)
    V = feats.shape[1]
    model = CvaMVSNet(depth_num=(8, 8, 4), dtype=dtype)
    ref = feats[:, 0, None]
    p2w = ref_pixel_to_world(K, c2w[:, 0])
    sums, acc = None, None
    for v in range(1, V):
        sums = plane_sweep_variance(feats[:, v], depth, sums, src_K=K,
                                    src_cam_to_world=c2w[:, v], ref_p2w=p2w)
        warped, _ = plane_sweep_warp(
            feats[:, v], depth, src_K=K, src_cam_to_world=c2w[:, v],
            ref_K=K, ref_cam_to_world=c2w[:, 0], with_mask=False,
            ref_p2w=p2w)
        terms = model._view_contrib(warped, ref, None)
        acc = list(terms) if acc is None else [a + t for a, t in
                                               zip(acc, terms)]
    assert all(s.dtype == dtype for s in sums)
    assert torch.equal(sums[0], acc[0]) and torch.equal(sums[1], acc[1])
    assert torch.equal(
        CvaMVSNet._finalize_volume(sums, ref, V, gated=False),
        CvaMVSNet._finalize_volume(acc, ref, V, gated=False))


def test_variance_step_checks_its_sums():
    feats, K, c2w, depth = _sweep(torch.float32)
    mat = torch.zeros(1, 3, 4)
    img = feats[:, 1].contiguous()
    sums = bs.warp_variance(img, mat, depth)
    with pytest.raises(ValueError):
        bs.warp_variance(img, mat, depth, (sums[0][:, :-1], sums[1]))
    with pytest.raises(ValueError):
        bs.warp_variance(img, mat, depth,
                         (sums[0].to(torch.bfloat16), sums[1]))


def test_seeded_unit_round_trip(tmp_path):
    """The unit the seeded mapping driver writes: its pickle loads through
    ``convert`` into the ungated model, every tensor the seed's draw, and
    its model_config.json builds that model; one seed gives one unit."""
    model = CONFIG["model"]
    unit = _unit(tmp_path, model)
    cfg = load_model_config(str(unit))
    assert cfg == {k: tuple(v) if isinstance(v, list) else v
                   for k, v in model.items()}
    net = CvaMVSNet(**cfg)
    variables = load_variables(str(unit / "model_variables.pkl"))
    net.load_state_dict(flax_to_state_dict(variables,
                                           view_aggregation=False))
    drawn = weights.init_params(model, SEED, "cpu")
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = v
    walk(variables, "")
    assert set(flat) == set(drawn)
    assert all(np.array_equal(flat[k], drawn[k].numpy()) for k in drawn)
    other = load_variables(str(_unit(tmp_path, model, SEED + 1)
                               / "model_variables.pkl"))
    kernel = ("params", "feature_net", "conv0_0", "conv", "kernel")

    def leaf(tree):
        for k in kernel:
            tree = tree[k]
        return tree
    assert not np.array_equal(leaf(other), leaf(variables))


def test_runner_records_the_variance_launches(tmp_path, monkeypatch):
    """The runner samples ``warp_variance.launches`` a call that moved it
    (the card's launches; a stand-in forward moves it here) and records
    nothing for a call that did not."""
    log = deque(maxlen=tm.LOG_ENTRIES)
    monkeypatch.setattr(tm, "LOG", log)
    unit = _unit(tmp_path, _model_config((8, 8, 4)))
    runner = _runner(unit, 3)
    runner.timer = tm.Timer()
    forward = runner._forward

    def launching(*inputs):
        bs.warp_variance.launches += 9
        return forward(*inputs)
    rec = _window(3)
    args = runner.pack_inputs(rec["bgrs"], rec["c2w"], rec["K"])
    runner._run(*args, 0.01, 6.0, 10.0)
    assert not [e for e in log if e.name == "warp_variance.launches"]
    runner._forward = launching
    runner._run(*args, 0.01, 6.0, 10.0)
    got = [e.value for e in log if e.name == "warp_variance.launches"]
    assert got == [9]


def test_eval_cli_takes_the_architecture_from_the_unit(tmp_path):
    """tandem_eval builds the unit's architecture from its
    model_config.json (here CasMVSNet's, no view aggregation, 8/8/4
    planes) with no architecture flag; ``--no-view-aggregation`` and
    ``--depth-num`` name it where a checkpoint has no model_config.json."""
    from tandem_tpu_torch.cli import tandem_eval
    unit = _unit(tmp_path, _model_config((8, 8, 4)))
    ckpt = unit / "model_variables.pkl"
    errors = tandem_eval.main(tandem_eval.parser.parse_args([
        "--ckpt", str(ckpt), "--data-root", str(MINI), "--width", "96",
        "--height", "64", "--limit", "1", "--device", "cpu"]))
    for stage in ("stage1", "stage2", "stage3"):
        assert np.isfinite(list(errors[stage].values())).all()
    bare = tmp_path / "bare.pkl"
    bare.write_bytes(ckpt.read_bytes())
    args = tandem_eval.parser.parse_args([
        "--ckpt", str(bare), "--data-root", str(MINI), "--width", "96",
        "--height", "64", "--limit", "1", "--device", "cpu",
        "--no-view-aggregation", "--depth-num", "8,8,4"])
    assert tandem_eval.model_kwargs(args) == {
        "depth_num": (8, 8, 4), "view_aggregation": False}
    tandem_eval.main(args)
    defaults = tandem_eval.parser.parse_args(["--ckpt", str(bare),
                                              "--data-root", str(MINI)])
    assert tandem_eval.model_kwargs(defaults) == {
        "depth_num": (48, 32, 8), "view_aggregation": True}


# --- on the card ---------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


# CasMVSNet's stages at 1152 x 864 (planes, rows, columns, channels), and
# a ragged shape whose channels take 3 lanes a sample in float32
SWEEPS = ((48, 216, 288, 32), (32, 432, 576, 16), (8, 864, 1152, 8),
          (5, 37, 53, 12))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SWEEPS)
def test_variance_kernel_equals_plain_on_card(dev, dtype, shape):
    """Four source views of each DTU stage (and a ragged sweep) through the
    kernel and through the plain version on the card: equal bit for bit
    (the kernel rounds where the plain version does, with no contraction
    into FMAs), in float32 and bfloat16 alike; one launch a view."""
    D, h, w, C = shape
    feats, K, c2w, depth = _sweep(dtype, V=5, D=D, h=h, w=w, C=C, seed=C)
    K = K.clone()
    K[:, :2] *= w / 28.0
    feats, K, c2w, depth = (x.to(dev) for x in (feats, K, c2w, depth))
    p2w = ref_pixel_to_world(K, c2w[:, 0])
    sums, plain = None, None
    before = bs.warp_variance.launches
    for v in range(1, 5):
        img = feats[:, v].contiguous()
        mat = ref_to_src_matrix(K, c2w[:, v], ref_p2w=p2w)
        sums = bs.warp_variance(img, mat, depth, sums)
        if plain is None:
            shape = sums[0].shape
            plain = (torch.empty(shape, dtype=dtype, device=dev),
                     torch.empty(shape, dtype=dtype, device=dev))
        bs.warp_variance_plain(img, mat, depth, *plain, v == 1)
    torch.cuda.synchronize()
    assert bs.warp_variance.launches == before + 4
    assert torch.equal(sums[0], plain[0]) and torch.equal(sums[1], plain[1])
    assert float(sums[1].float().abs().sum()) > 0


@pytest.mark.cuda
def test_graphed_runner_equals_eager_at_the_dtu_size(dev, tmp_path):
    """The runner at 5 views and 1152 x 864 with seeded CasMVSNet weights in
    float32 (their BatchNorm statistics calibrated on the scene): the
    eager call, the call that captures the CUDA graph and a replay give
    the same four outputs bit for bit, as a fresh eager
    ``Stage3Forward`` does; 12 variance launches (3 stages x 4 source
    views) and one edge filter a call, counted at each replay, and no
    warp_sample launch."""
    from tandem_tpu_torch.ops.edge_kth import edge_filter
    unit = _unit(tmp_path, CONFIG["model"], V=5, width=1152, height=864,
                 device=dev)
    runner = _runner(unit, 5, device=dev, width=1152, height=864)
    rec = _window(5, 1152, 864, dev)
    names = ("depth", "confidence", "depth_dense", "confidence_dense")
    outs, served = [], []
    sampled = bs.warp_sample.launches
    for _ in range(3):
        launches, calls = bs.warp_variance.launches, edge_filter.calls
        runner.call_async(rec["bgrs"], rec["c2w"], rec["K"], rec["dmin"],
                          rec["dmax"], 10.0)
        got = runner.get_result(device=True)
        outs.append([got[k].clone() for k in names])
        torch.cuda.synchronize()
        served.append(runner._forward.served)
        assert bs.warp_variance.launches == launches + 12
        assert edge_filter.calls == calls + 1
    assert served == ["eager", "capture", "replay"]
    assert bs.warp_sample.launches == sampled
    with torch.no_grad():
        eager = Stage3Forward(runner.model)(*runner._device_inputs(
            *runner.pack_inputs(rec["bgrs"], rec["c2w"], rec["K"]),
            rec["dmin"], rec["dmax"], 10.0))
    for out in outs[1:] + [[x[0] for x in eager]]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))
    depth = outs[0][2]
    assert bool(torch.isfinite(depth).all()) and float(depth.min()) > 0
