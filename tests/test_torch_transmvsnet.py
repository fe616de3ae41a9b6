"""TransMVSNet through the port: against the benchmark's plain reference
(``benchmark/reference/transmvsnet.py``) on seeded weights at small sizes on
the CPU, stage by stage; the FMT, ARF and the correlation step
(``ops/bilinear_sample.warp_correlation``) on their own; a unit that names
the architecture, built by the factory and served by the runner; and, on
the card (``-m cuda``), the kernel against its plain version and the
runner's CUDA graph against its eager forward at the DTU test size (5
views, 1152 x 864), with the FMT's device time. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_transmvsnet.py
"""

import json
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference.transmvsnet import PlainTransMVSNet, param_shapes
from benchmark.traffic import common, scene, weights
from benchmark.traffic.mapping_arch import reference_model, write_unit
from benchmark.traffic.mapping_seeded import calibration_windows
from tandem_tpu_torch.cli.golden import load_model_config
from tandem_tpu_torch.models import transmvsnet as tm_model
from tandem_tpu_torch.models.convert import flax_to_state_dict, load_variables
from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet, Stage3Forward
from tandem_tpu_torch.models.factory import build_model
from tandem_tpu_torch.models.layers import ModulatedDeformConv3x3
from tandem_tpu_torch.ops import bilinear_sample as bs
from tandem_tpu_torch.ops.warp import ref_pixel_to_world, ref_to_src_matrix
from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
from tandem_tpu_torch.utils import timer as tm

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" /
                     "transmvsnet_dtu_1152x864.json").read_text())
PATH = json.loads((ROOT / "benchmark" / "workloads" /
                   "kf_stream_seeded_arch.json").read_text())["path"]
W, H = 96, 64
SEED = 2 ** 31 + 23
SMALL = (8, 8, 4)         # the fewest planes the cascade's U-Nets take


@pytest.fixture(autouse=True)
def one_thread():
    """Six pytest workers share the CPU: an OpenMP pool a worker starves
    the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(depth_num=SMALL, depth_head="wta"):
    return dict(CONFIG["model"], depth_num=list(depth_num),
                depth_head=depth_head)


def _window(V, width=W, height=H, device="cpu"):
    """A V-view window of the path, as the mapping driver records a call
    (the second newest view is the reference)."""
    f = 675.0 * width / 1152
    cam = scene.Camera(width, height, f, f)
    frames = [8 * j for j in range(V)]
    bgrs, _, _ = scene.render_frames(frames, PATH, cam,
                                     scene.texture_offset(16), device)
    return {"bgrs": list(bgrs), "K": cam.K, "dmin": 0.01, "dmax": 6.0,
            "discard": 10.0,
            "c2w": [scene.path_pose(f, PATH).astype(np.float32)
                    for f in frames]}


def _unit(tmp_path, model, V=0, width=W, height=H, device="cpu",
          seed=SEED):
    """A seeded unit as the benchmark's driver writes it; with ``V``, its
    BatchNorm statistics calibrated on the stream's V-view windows."""
    unit = tmp_path / f"unit_{seed}"
    unit.mkdir()
    f = 675.0 * width / 1152
    windows = calibration_windows(
        dict(CONFIG, views=V, image={"width": width, "height": height,
                                     "fx": f, "fy": f}),
        {"path": PATH, "keyframe_every": 8, "decor_seed": 16,
         "discard_percentage": 10.0}, device) if V else ()
    write_unit(unit, model, seed, device, windows)
    return unit


def _runner(unit, V, device="cpu", width=W, height=H, dtype=torch.float32):
    model = build_model(load_model_config(str(unit)), dtype)
    return MvsnetRunner(model, load_variables(str(unit /
                                                  "model_variables.pkl")),
                        height, width, view_num=V, device=device)


def _stages(unit, model, V, rec, dtype=torch.float32):
    """Every stage of the port's model and of the plain reference on one
    window: {stage: (depth, confidence, reference depth, reference
    confidence)}, and the runner's filtered stage 3 against the
    reference's (``mvs_gaps``)."""
    inputs = common.reference_inputs(rec, "cpu")
    ref = reference_model(Path("/"), {"unit": str(unit), "model": model},
                          "cpu")
    stages = ref.cascade(*inputs[:5])
    runner = _runner(unit, V, dtype=dtype)
    args = runner.pack_inputs(rec["bgrs"], rec["c2w"], rec["K"])
    dev = runner._device_inputs(*args, rec["dmin"], rec["dmax"],
                                rec["discard"])
    out = runner.model(dev[0], dev[1:4], *dev[4:7])
    got = {name: (getattr(out, name).depth, getattr(out, name).confidence,
                  *stages[name]) for name in stages}
    filtered = runner._run(*args, rec["dmin"], rec["dmax"], rec["discard"])
    want = ref(*inputs)
    return got, common.mvs_gaps(filtered[0], filtered[1], want[0], want[1])


# Tolerances of the port against the reference (float32, the same seeded
# weights, BatchNorm calibrated on the scene so that the depth follows the
# cost volume). The two round differently: ``grid_sample`` against the
# plain sample, the channel mean against the kernel's order, einsum
# against matmuls, another order of the DCN's taps; ~40 layers carry
# those float32 roundings (a few 1e-7 relative) to the logits.
# - A winner-take-all depth is one of the stage's planes: a rounding-level
#   change of two near-equal plane probabilities picks the other plane, and
#   the next stage's planes move with it. At most FLIP_SHARE of the pixels
#   may take another plane (depths apart by more than 1e-4 of the largest
#   reference depth: a stage-3 plane interval is ~5e-3 of it); the rest
#   agree within DEPTH_TOL["wta"] of that depth (the planes themselves come
#   from the same depths through two interpolations and a clamp at 1 mm,
#   each a few float32 ulps of the range; read 2.2e-7).
# - The regression head's depth is the planes' mean under the softmax: the
#   logits' rounding moves it continuously, within DEPTH_TOL["regression"]
#   of the largest depth (read 1.7e-6); no pixel may part by 1e-4.
# - The confidence is continuous: within CONF_TOL wherever the stage's
#   planes agree, except at most CONF_OFF_SHARE of the pixels whose
#   expected index a rounding moves across a plane.
FLIP_SHARE = 2e-2
DEPTH_TOL = {"wta": 1e-6, "regression": 1e-5}
CONF_TOL = 1e-4
CONF_OFF_SHARE = 1e-2


def _held(got):
    """Each stage's readings of the tolerances above."""
    out = {}
    for name, (depth, conf, rdepth, rconf) in got.items():
        gap = (depth - rdepth).abs() / rdepth.max()
        flipped = gap > 1e-4
        conf_off = ((conf - rconf).abs() > CONF_TOL) & ~flipped
        out[name] = {"flip": float(flipped.float().mean()),
                     "depth_gap": float(gap[~flipped].max()),
                     "conf_off": float(conf_off.float().mean()),
                     "spread": float(rdepth.std())}
    return out


def _holds(readings, head: str = "wta") -> bool:
    return all(r["flip"] <= FLIP_SHARE and r["depth_gap"] <= DEPTH_TOL[head]
               and r["conf_off"] <= CONF_OFF_SHARE for r in readings.values())


@pytest.mark.parametrize("head", ["wta", "regression"])
def test_program_equals_the_plain_reference(tmp_path, head):
    """Seeded weights calibrated on the scene, 3 views at 96 x 64, 8/8/4
    planes, with either depth head (the published winner-take-all and the
    benchmark's regression): every stage of the port's TransMVSNet against
    the plain reference within the tolerances above (read: no pixel
    parted by 1e-4, no confidence off), the depth spread over the image by
    more than a quarter of a stage-1 plane interval (it follows the cost
    volume); the runner's filtered stage 3 within the benchmark's
    readings; and the same port in bfloat16 fails them (read: 2-98% of the
    pixels parted by more than 1e-4)."""
    model = _model(depth_head=head)
    unit = _unit(tmp_path, model, V=3)
    rec = _window(3)
    got, gaps = _stages(unit, model, 3, rec)
    readings = _held(got)
    assert _holds(readings, head), readings
    base = rec["dmax"] / (SMALL[0] - 1)
    assert readings["stage1"]["spread"] > 0.25 * base, readings
    assert gaps["mask_flip_share"] <= 2e-2 and gaps["conf_gap"] < 1e-4, gaps
    low, _ = _stages(unit, model, 3, rec, dtype=torch.bfloat16)
    assert not _holds(_held(low), head)


def test_a_dropped_source_view_is_seen(tmp_path, monkeypatch):
    """The last source view of each stage dropped from the cost (its
    similarity replaced by the first source view's, so the cost is that
    view's alone) moves the calibrated depth past the tolerances above.
    (Zeroing its similarity instead would scale the cost by the weights'
    share, about a half: the calibrated U-Net, BatchNorm near mean 0 and
    bias 0, is nearly positively homogeneous and keeps its arg-max.)"""
    model = _model()
    unit = _unit(tmp_path, model, V=3)
    real, first = tm_model.plane_sweep_correlation, []

    def dropping(*a, **k):
        sim = real(*a, **k)
        first.append(sim)
        return first[-2] if len(first) % 2 == 0 else sim
    monkeypatch.setattr(tm_model, "plane_sweep_correlation", dropping)
    got, _ = _stages(unit, model, 3, _window(3))
    assert len(first) >= 6
    readings = _held(got)
    assert not _holds(readings), readings


def test_fmt_never_updates_the_reference_from_a_source():
    """The reference view's tokens out of the FMT are the same whatever the
    source views hold, and equal the reference's own FMT on it alone; a
    source's depend on the reference."""
    torch.manual_seed(0)
    fmt = tm_model.FeatureMatchingTransformer(32, 8, 4)
    for p in fmt.parameters():
        torch.nn.init.normal_(p, std=0.2)
    f = torch.randn(1, 3, 32, 6, 10)
    g = f.clone()
    g[:, 1:] = torch.randn(1, 2, 32, 6, 10)
    a, b = fmt(f), fmt(g)
    assert torch.equal(a[:, 0], b[:, 0])
    assert not torch.allclose(a[:, 1:], b[:, 1:])
    h = f.clone()
    h[:, 0] += 1.0
    assert not torch.allclose(fmt(h)[:, 1], a[:, 1])


def test_fmt_equals_the_reference_encoder():
    """The port's FMT on seeded weights against the reference's einsum
    form: float32 rounding apart (matmuls against einsum)."""
    model = _model()
    params = _drawn(model)
    net = build_model({k: tuple(v) if isinstance(v, list) else v
                       for k, v in model.items()})
    net.load_state_dict(flax_to_state_dict(weights.nested_numpy(params),
                                           architecture="transmvsnet"))
    ref = PlainTransMVSNet(params, model)
    f = torch.randn(2, 3, 32, 8, 12, generator=torch.Generator()
                    .manual_seed(1))
    got, want = net.fmt(f), ref._fmt(f)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), \
        float((got - want).abs().max())


def _drawn(model):
    """The seeded unit's parameters, {flax path: tensor}."""
    saved = weights.param_shapes
    weights.param_shapes = param_shapes
    try:
        return weights.init_params(model, SEED, "cpu")
    finally:
        weights.param_shapes = saved


def test_arf_with_zero_offsets_and_unit_modulation_is_a_convolution():
    """Offsets 0 and modulation 1 (a sigmoid of 100): the deformable layer
    is its 3x3 convolution (zero padding), to grid_sample's rounding of
    the integer positions."""
    torch.manual_seed(0)
    layer = ModulatedDeformConv3x3(8, 6)
    with torch.no_grad():
        layer.offset.weight.zero_()
        layer.offset.bias.zero_()
        layer.mask.weight.zero_()
        layer.mask.bias.fill_(100.0)
    x = torch.randn(2, 8, 11, 13)
    want = torch.nn.functional.conv2d(x, layer.conv.weight, padding=1)
    assert torch.allclose(layer(x), want, rtol=1e-5, atol=1e-5)


def _sweep(dtype, V=3, B=1, D=6, h=20, w=28, C=8, seed=0):
    """Features, ref -> src matrices and depth hypotheses of a small plane
    sweep whose samples leave the image and fall behind some sources."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(B, V, h, w, C, generator=g).to(dtype)
    K = torch.tensor([[[20.0, 0, 13.5], [0, 20.0, 9.5], [0, 0, 1]]])
    c2w = torch.eye(4).repeat(B, V, 1, 1)
    c2w[:, :, 0, 3] = 0.3 * torch.arange(V) - 0.6
    c2w[:, :, 2, 3] = 0.4 * torch.arange(V) - 0.8
    depth = torch.rand(B, D, h, w, generator=g) * 4 + 0.2
    return feats, K.repeat(B, 1, 1), c2w, depth


@pytest.mark.parametrize("C", [8, 12])
def test_correlation_step_equals_the_eager_channel_mean(C):
    """``warp_correlation`` on the CPU (its plain version) against the
    eager warp times the reference, averaged over the channels: the same
    value to float32 rounding of the sum's order, and its order
    (``correlation_vec``'s lanes) exactly."""
    feats, K, c2w, depth = _sweep(torch.float32, C=C)
    ref = feats[:, 0].contiguous()
    img = feats[:, 1].contiguous()
    mat = ref_to_src_matrix(K, c2w[:, 1],
                            ref_p2w=ref_pixel_to_world(K, c2w[:, 0]))
    got = bs.warp_correlation(img, ref, mat, depth)
    warped = bs.warp_sample_plain(img, mat, depth)
    eager = (warped * ref[:, None]).mean(-1)
    assert got.dtype == torch.float32 and got.shape == depth.shape
    assert torch.allclose(got, eager, rtol=0, atol=1e-6)
    vec = bs.correlation_vec(img, ref)
    prod = (warped * ref[:, None]).reshape(*depth.shape, C // vec, vec)
    total = _ordered(torch.stack([_ordered(prod[..., lane, :])
                                  for lane in range(C // vec)], -1))
    assert torch.equal(got, total / torch.full((), float(C)))
    assert float(got.abs().max()) > 0


def _ordered(x):
    s = x[..., 0]
    for e in range(1, x.shape[-1]):
        s = s + x[..., e]
    return s


def test_a_unit_that_names_the_architecture_is_served(tmp_path,
                                                      monkeypatch):
    """A unit whose model_config.json says "architecture": "transmvsnet"
    builds a TransMVSNet through ``load_model_config`` and the factory,
    loads its pickle through ``convert`` and is served by ``MvsnetRunner``
    on the CPU; the runner records ``warp_correlation.launches`` for a call
    that moved it (the card's launches; a stand-in moves it here)."""
    log = deque(maxlen=tm.LOG_ENTRIES)
    monkeypatch.setattr(tm, "LOG", log)
    unit = _unit(tmp_path, _model(depth_head=CONFIG["model"]["depth_head"]))
    assert load_model_config(str(unit))["architecture"] == "transmvsnet"
    runner = _runner(unit, 3)
    assert isinstance(runner.model, tm_model.TransMVSNet)
    assert runner.model.depth_head == CONFIG["model"]["depth_head"]
    runner.timer = tm.Timer()
    rec = _window(3)
    args = runner.pack_inputs(rec["bgrs"], rec["c2w"], rec["K"])
    out = runner._run(*args, 0.01, 6.0, 10.0)
    assert [tuple(x.shape) for x in out] == [(1, H, W)] * 4
    assert bool(torch.isfinite(out[2]).all()) and float(out[2].min()) > 0
    assert not [e for e in log if e.name == "warp_correlation.launches"]
    forward = runner._forward

    def launching(*inputs):
        bs.warp_correlation.launches += 6
        return forward(*inputs)
    runner._forward = launching
    runner._run(*args, 0.01, 6.0, 10.0)
    assert [e.value for e in log
            if e.name == "warp_correlation.launches"] == [6]


def test_a_unit_without_the_key_builds_cva_mvsnet(tmp_path):
    """No "architecture" key: the factory builds CVA-MVSNet from the same
    kwargs as before, and asking for an unknown one raises."""
    unit = tmp_path / "unit"
    unit.mkdir()
    (unit / "model_config.json").write_text(json.dumps(
        {"depth_num": [48, 4, 4], "view_aggregation": True}))
    model = build_model(load_model_config(str(unit)))
    assert type(model) is CvaMVSNet and model.view_aggregation
    assert model.depth_num == (48, 4, 4)
    with pytest.raises(ValueError):
        build_model({"architecture": "patchmatchnet"})
    with pytest.raises(ValueError):
        build_model(dict(_model(), depth_head="soft"))
    with pytest.raises(ValueError):
        PlainTransMVSNet({}, dict(_model(), architecture="cva_mvsnet"))


# --- on the card ---------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


# TransMVSNet's stages at 1152 x 864 (planes, rows, columns, channels), and
# a ragged shape whose channels take 3 lanes a sample in float32
SWEEPS = ((48, 216, 288, 32), (32, 432, 576, 16), (8, 864, 1152, 8),
          (5, 37, 53, 12))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SWEEPS)
def test_correlation_kernel_equals_plain_on_card(dev, dtype, shape):
    """Four source views of each DTU stage (and a ragged sweep) through the
    kernel and through the plain version on the card: equal bit for bit
    (the kernel rounds where the plain version does, in its channel
    order, with no contraction into FMAs); one launch a view."""
    D, h, w, C = shape
    feats, K, c2w, depth = _sweep(dtype, V=5, D=D, h=h, w=w, C=C, seed=C)
    K = K.clone()
    K[:, :2] *= w / 28.0
    feats, K, c2w, depth = (x.to(dev) for x in (feats, K, c2w, depth))
    p2w = ref_pixel_to_world(K, c2w[:, 0])
    ref = feats[:, 0].contiguous()
    before = bs.warp_correlation.launches
    for v in range(1, 5):
        img = feats[:, v].contiguous()
        mat = ref_to_src_matrix(K, c2w[:, v], ref_p2w=p2w)
        got = bs.warp_correlation(img, ref, mat, depth)
        want = bs.warp_correlation_plain(img, ref, mat, depth)
        assert torch.equal(got, want), (v, float((got - want).abs().max()))
        assert float(got.abs().max()) > 0
    torch.cuda.synchronize()
    assert bs.warp_correlation.launches == before + 4


@pytest.fixture
def dtu_runner(dev, tmp_path):
    """The runner at 5 views and 1152 x 864 with seeded TransMVSNet weights
    (their BatchNorm statistics calibrated on the scene), and a window."""
    unit = _unit(tmp_path, CONFIG["model"], V=5, width=1152, height=864,
                 device=dev)
    return (_runner(unit, 5, device=dev, width=1152, height=864),
            _window(5, 1152, 864, dev))


@pytest.mark.cuda
def test_graphed_runner_equals_eager_at_the_dtu_size(dtu_runner):
    """The eager call, the call that captures the CUDA graph and a replay
    give the same four outputs bit for bit, as a fresh eager
    ``Stage3Forward`` does; 12 correlation launches (3 stages x 4 source
    views) and one edge filter a call, counted at each replay; no
    warp_sample or warp_variance launch."""
    from tandem_tpu_torch.ops.edge_kth import edge_filter
    runner, rec = dtu_runner
    names = ("depth", "confidence", "depth_dense", "confidence_dense")
    outs, served = [], []
    others = bs.warp_sample.launches, bs.warp_variance.launches
    for _ in range(3):
        launches, calls = bs.warp_correlation.launches, edge_filter.calls
        runner.call_async(rec["bgrs"], rec["c2w"], rec["K"], rec["dmin"],
                          rec["dmax"], 10.0)
        got = runner.get_result(device=True)
        outs.append([got[k].clone() for k in names])
        torch.cuda.synchronize()
        served.append(runner._forward.served)
        assert bs.warp_correlation.launches == launches + 12
        assert edge_filter.calls == calls + 1
    assert served == ["eager", "capture", "replay"]
    assert (bs.warp_sample.launches, bs.warp_variance.launches) == others
    with torch.no_grad():
        eager = Stage3Forward(runner.model)(*runner._device_inputs(
            *runner.pack_inputs(rec["bgrs"], rec["c2w"], rec["K"]),
            rec["dmin"], rec["dmax"], 10.0))
    for out in outs[1:] + [[x[0] for x in eager]]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))
    depth = outs[0][2]
    assert bool(torch.isfinite(depth).all()) and float(depth.min()) > 0


@pytest.mark.cuda
def test_fmt_device_ms_agrees_with_events_on_card(dtu_runner, monkeypatch):
    """``fmt.device_ms``, sampled a call from the events the model records
    around its FMT (eagerly, at the capture and at each replay), within
    10% of CUDA events around the FMT run eagerly on the same features."""
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    log = deque(maxlen=tm.LOG_ENTRIES)
    monkeypatch.setattr(tm, "LOG", log)
    runner, rec = dtu_runner
    runner.timer = tm.Timer()
    for _ in range(6):
        runner.call_async(rec["bgrs"], rec["c2w"], rec["K"], rec["dmin"],
                          rec["dmax"], 10.0)
        runner.get_result(device=True)
    runner.wait()
    runner.call_async(rec["bgrs"], rec["c2w"], rec["K"], rec["dmin"],
                      rec["dmax"], 10.0)       # reads the sixth call's
    runner.get_result(device=True)
    got = [e.value for e in log if e.name == "fmt.device_ms"]
    assert len(got) >= 6, got
    model = runner.model
    image = runner._device_inputs(*runner.pack_inputs(
        rec["bgrs"], rec["c2w"], rec["K"]), rec["dmin"], rec["dmax"],
        10.0)[0]
    with torch.no_grad():
        feats = model.feature_net(image.reshape(5, 3, 864, 1152))
        f1 = model.arf["stage1"](feats["stage1"]).reshape(
            1, 5, *feats["stage1"].shape[1:])
        want = cuda_ms(lambda: model.fmt(f1), iters=10)
    replayed = float(np.median(got[2:]))
    assert abs(replayed - want) <= 0.1 * want, (got, want)
