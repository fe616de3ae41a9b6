"""Inputs, bars and launch counters shared by the port's card tests
(``tests/test_torch_cuda.py``) and the CPU tests of the tracker: seeded
tracker levels and the LM kernel's step check, the golden pack's plane
sweeps, and runs of the port's CLIs on the trajectory fixture. Each bar
keeps the source of its number. Imports only numpy, torch and the port:
the card's machine has no JAX.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tandem_tpu_torch.cli.golden import GOLDEN_TOL

REPO = Path(__file__).resolve().parent.parent
UNIT = REPO / "exported" / "tandem"
BF16_TOL = 10 * GOLDEN_TOL   # tandem_tpu/cli/tandem_dataset.py:107-108
N_KEYFRAMES = 4
FIXTURE = REPO / "tests" / "fixtures" / "replica_traj" / "scene0"

# K6 against float64: relative to the largest |entry| of each output. The
# f32 sums of up to 42,496 x 15 terms stay near 1e-6; a point whose border
# or cutoff test flips between f32 and f64 moves the energy by <= 400 of
# ~10^6.
TRACK_TOL = 1e-4
GT_TRACK_BOUND = 5e-3        # m; the JAX package gets ~1 mm on this loop
# m. tests/test_torch_tracker.py::test_track_against_the_mvs_model: the
# map from TandemBackend on replica_traj's first two 7-view windows
# (trained abl04, f32), the reference at the newest keyframe of window 2,
# then the 8 frames after it. 1.5 x the worst JAX position error measured
# there on the CPU (35.488 mm at the 8th frame; the error grows about
# linearly along the 8 frames, both packages alike).
MVS_TRACK_BOUND = 0.0532
# The SLAM loop on the trajectory fixture: tests/test_vo_ate.py's bars
# (the JAX package on the CPU reads 10.26 mm VO only, 10.15 mm full).
SLAM_ATE_BOUND = 0.030
SLAM_MIN_FRAMES = 56
# bench_runtime.py's synthetic sequence (60 frames, the textured plane at
# depth 2, the camera moving 0.015 a frame along x) through tandem_dataset
# preset=runtime with the trained unit, and the poses the run must keep.
RUNTIME_FRAMES = 60
RUNTIME_MIN_POSES = 56
# The demo test replays the fixture's first DEMO_FRAMES frames: all 64,
# since its first 40 make 6 keyframes (the CPU rehearsal) and the 7-view
# window, so the backend and its sinks, would never run.
DEMO_FRAMES = 64
# track_lm, one step against float64 (_lm_one_step). dx must solve
# the kernel's own damped system to a componentwise backward error of
# LM_SOLVE_TOL, |Hl dx + g| / (|Hl| |dx| + |g|) (the f32 plain step: <=
# 1.5e-7 on the CPU), and agree with the float64 plain step, relative to
# its largest |entry|, within LM_DX_TOL: their sums differ, and dx's
# offset entry is about -sum(w r) / sum(w), a sum that cancels near
# convergence (the f32 plain step is 2.1e-3 off on the CPU). For the same
# reason, and because each residual is a difference of intensities of
# ~100 that f32 rounds by ~1e-5, e and g are held within TRACK_TOL of
# their Cauchy-Schwarz scales with a floor of one grey level a term,
# e + n and sqrt(H_ii (e + n)), not of their own size. T_new carries dx's
# error: against the step, relative to its largest |dx|, within
# LM_DX_TOL; against se3_exp(dx) @ T of the kernel's own dx in float64
# within LM_SE3_TOL of its largest entry (or of 1; the f32 plain step:
# <= 3e-7 on the CPU, ~5 f32 ulps of 1), or within 4x the plain f32
# update's own error on the same dx where that is larger (far poses and
# large steps at the 16x12 level: 2e-6).
LM_SOLVE_TOL = 1e-5
LM_DX_TOL = 1e-2
LM_SE3_TOL = 2e-6
# The Student-t step's dx and T_new against the step: within LM_DX_TOL,
# or within LM_DX_PLAIN_X times the plain f32 step's own distance from
# the float64 step from the same state, where that is larger. The t
# weights share one scale, a fixed point of sums whose start takes the
# residuals at or below their mean: rounding moves the scale and with it
# every weight, and near convergence dx is a small difference of such
# weighted sums (the plain f32 step is up to 8.6e-2 off float64 in dx on
# the CPU at the tracker's caps, against 1.8e-3 with the Huber weights).
LM_DX_PLAIN_X = 4.0
# A candidate whose accept or convergence test lies within this relative
# margin of its threshold in float64 is a tie: f32 sums may decide it
# either way.
LM_TIE = 1e-5
# A whole level's end point, kernel against the plain f32 version on the
# card: within LM_POSE_PX pixels of motion at the level's focal length
# (|dT| <= LM_POSE_PX / fx) and aff within LM_AFF_TOL (its offset is in
# grey levels). The sums differ in order, so the LM's stopping rule (a
# relative improvement below 1e-4) and its accept test can flip on a
# near-tie; on the few hundred points of the 16x12 level the two paths
# then part for good (f32 against f64 on the CPU: 0.19 px; the kernel
# against the plain version on the card: 0.19 px at B = 5).
LM_POSE_PX = 0.5
LM_AFF_TOL = 0.05
# The RGB-D path (_rgbd_run): SE(3) ATE without scale on replica_traj
# within 1.5 x the JAX package's on the CPU over the same 64 frames (the
# MVS map's 1.5 x convention): 1.9844264140336252 mm, printed by
# tests/test_torch_rgbd.py::test_replica_traj_rgbd_ate (the port on the
# CPU: 1.859570720845736 mm).
RGBD_ATE_BOUND = 1.5 * 1.9844264140336252e-3
# The VO run's frames whose final pose is dvo's (neither the fallback's nor
# the retry ladder's): the JAX package's count on the CPU over the same 64
# frames, printed by the same test (frames 1-7; the port on the CPU: 7).
# After the ladder's first firing every frame retries (PERF.md), so a
# gate decision that flips on the card moves the count by one frame.
RGBD_DVO_POSES = 7
RGBD_DVO_POSES_SLACK = 1
# abl04 at 640x480: per stage (depth planes, H, W, feature channels).
STAGE_SHAPES = {"stage1": (48, 120, 160, 32), "stage2": (4, 240, 320, 16),
                "stage3": (4, 480, 640, 8)}
# The same at 256x192, the trajectory fixture's size.
SLAM_STAGE_SHAPES = {"stage1": (48, 48, 64, 32), "stage2": (4, 96, 128, 16),
                     "stage3": (4, 192, 256, 8)}
# The training and eval tests: tandem_train on the trajectory fixture
# (abl04 at 640x480, B = 2), the learning curve's gate and steps
# (tests/test_train_learns.py's), and tandem_eval on replica_mini
# (tests/test_eval_fixture.py's reference numbers and tolerance).
TRAIN_ROOT = REPO / "tests" / "fixtures" / "replica_traj"
EVAL_ROOT = REPO / "tests" / "fixtures" / "replica_mini"
EVAL_UNIT = REPO / "exported" / "tandem_512x320"
CURVE_STEPS = 41
BF16_STEPS = 8
REF_ABS_REL = {"48,32,8": {"stage1": 0.008706, "stage2": 0.177201,
                           "stage3": 0.144266},
               "48,4,4": {"stage1": 0.008706, "stage2": 0.006343,
                          "stage3": 0.006183}}
EVAL_TOL = 0.01
# f32, against the eager runner. The shards' FeatureNets see fewer images
# and the volumes are summed in another order, so the depth moves by what
# f32 rounding moves this cascade. The test measures that floor, what one
# ulp of the input image moves the eager forward's dense depth by, and
# holds the shards' depth within SHARD_FLOOR_X times it (the 5x of
# tests/test_torch_train.py's gradient bar), never tighter than the atol
# of tests/test_parallel.py:54-55's (rtol, atol); the pixels over those
# are counted. At 640x480 on the card that floor is above 1e-4 (2.685e-04
# against the shards' 3.182e-04 at n = 2 on an NVIDIA H100 80GB HBM3 at
# 700 W).
SHARD_FLOOR_X = 5
SHARD_DEPTH_TOL = (1e-4, 1e-4)
SHARD_CONF_TOL = (1e-3, 1e-3)
# The confidence reads the plane at the truncated expected index, and the
# filter keeps a rank of the edge values: where the last bits cross either
# cut, a pixel's confidence jumps or the pixel is kept by one runner only.
# At most this share of the pixels may (the CPU rehearsal at 512x320: 3
# and 2 of 163,840).
SHARD_FLIP_SHARE = 1e-4
# bf16: the JAX dry run's bar (__graft_entry__.py:249) on the relative L1
# error, mean |d - d0| / mean |d0|. Its max |d - d0| / max |d0| is not
# held at 640x480 with the trained weights: there bf16 itself moves some
# pixels by ~25% (the CPU rehearsal at 512x320: the eager bf16 runner
# against the f32 one 2.4e-1 by max, 2.0e-2 by L1; the sums' order, the
# shards against the eager bf16 runner, 8.5e-2 and 6.2e-3).
SHARD_BF16_REL = 2e-2
# 2 gloo ranks on one card at abl04's 640x480, 2 of these trajectory
# fixture tuples each, against one process at world_size 2 on all four.
DP_TUPLES = (0, 3, 7, 10)
DP_SIZE = (480, 640)
DP_STEPS = 3
DP_RTOL = 5e-3               # tests/test_train_learns.py:157, the JAX gate
ABL04_CONFIG = REPO / "tandem_tpu_torch" / "configs" \
    / "abl04_fewer_depth_planes.yaml"
# CostRegNet's decoder steps (ops/deconv3d.py) at the main path's shapes:
# the benchmark's abl04 cell (the trained unit in bfloat16), the trained
# unit in float32 (the golden pack) and the benchmark's CasMVSNet cell
# (seeded weights, float32): (weights, dtype, image (H, W), planes a
# stage).
DECONV_CONFIGS = {
    "abl04 bf16": ("unit", "bfloat16", (480, 640), (48, 4, 4)),
    "trained f32": ("unit", "float32", (480, 640), (48, 4, 4)),
    "CasMVSNet f32": ("seeded", "float32", (864, 1152), (48, 32, 8)),
}


def decoder_steps(model, size) -> list:
    """Each ``DeconvBnRelu`` call of ``model``'s (a ``CvaMVSNet``) cost
    regularisers in a forward at image ``size`` = (H, W), in call order:
    [(stage, layer name, Ci, Co, input (D, H, W), stride)]. Recorded by
    forward hooks on a meta copy of each stage's ``CostRegNet`` fed the
    stage's cost volume, (1, feature channels, planes, H / scale, W /
    scale) in the model's dtype; each call's skip must have the step's
    output shape."""
    import copy

    import torch

    from tandem_tpu_torch.models.layers import DeconvBnRelu
    from tandem_tpu_torch.ops.deconv3d import output_shape
    steps = []
    for i, (stage, net) in enumerate(model.cost_regularization_net.items()):
        def record(layer, args, kwargs, out, stage=stage):
            x, skip, stride = args[0], kwargs["skip"], tuple(layer.conv.stride)
            assert skip.shape == output_shape(x.shape, out.shape[1], stride)
            steps.append((stage, names[layer], x.shape[1], out.shape[1],
                          tuple(x.shape[2:]), stride))

        net = copy.deepcopy(net).to("meta")
        names = {m: n for n, m in net.named_children()
                 if isinstance(m, DeconvBnRelu)}
        hooks = [m.register_forward_hook(record, with_kwargs=True)
                 for m in names]
        scale = model.scale[stage]
        net(torch.empty((1, model.feature_net.out_channels[stage],
                         model.depth_num[i], size[0] // scale,
                         size[1] // scale), device="meta",
                        dtype=model.dtype))
        for h in hooks:
            h.remove()
    return steps


def step_inputs(step, dtype, device, seed: int = 0, skip: bool = True):
    """Seeded (x, weight, inv, off, skip) of a decoder step of
    ``decoder_steps``: x and the skip non-negative, as the ReLUs before
    them leave them (the skip None where ``skip`` is false)."""
    import torch
    _, _, Ci, Co, (D, H, W), stride = step
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.relu(torch.randn((1, Ci, D, H, W), generator=g,
                               device=device)).to(dtype)
    w = (torch.randn((Ci, Co, 3, 3, 3), generator=g, device=device)
         / (Ci * 27) ** 0.5).to(dtype)
    inv = (0.5 + torch.rand((Co,), generator=g, device=device)).to(dtype)
    off = (0.1 * torch.randn((Co,), generator=g, device=device)).to(dtype)
    out = (1, Co, stride[0] * D, 2 * H, 2 * W)
    s = torch.relu(torch.randn(out, generator=g, device=device)).to(dtype)
    return x, w, inv, off, s if skip else None


def wrappers() -> dict:
    """Each kernel's wrappers; their ``.launches`` count its launches."""
    from tandem_tpu_torch.ops.bilinear_index import bilinear_index
    from tandem_tpu_torch.ops.bilinear_sample import (bilinear_sample,
                                                      warp_sample,
                                                      warp_sample_grad,
                                                      warp_variance)
    from tandem_tpu_torch.ops.corner_blend import corner_blend
    from tandem_tpu_torch.ops.deconv3d import deconv_bn_relu_add
    from tandem_tpu_torch.ops.edge_kth import edge_filter, edge_kth_value
    from tandem_tpu_torch.ops.row_gather import row_gather
    from tandem_tpu_torch.ops.track_lm import lm_level
    from tandem_tpu_torch.ops.track_reduce import track_reduce
    from tandem_tpu_torch.mapping.tsdf import _fill_holes, integrate, splat_zbuf
    return {"edge_kth": (edge_filter, edge_kth_value),
            "bilinear_index": (bilinear_index,),
            "corner_blend": (corner_blend,),
            "bilinear_sample": (warp_sample, bilinear_sample),
            "warp_sample_grad": (warp_sample_grad,),
            "warp_variance": (warp_variance,),
            "deconv": (deconv_bn_relu_add,),
            "tsdf_integrate": (integrate,), "tsdf_splat": (splat_zbuf,),
            "tsdf_fill_holes": (_fill_holes,),
            "row_gather": (row_gather,), "track_reduce": (track_reduce,),
            "track_lm": (lm_level,)}


def reset_counts():
    from tandem_tpu_torch.ops.edge_kth import edge_filter
    for fns in wrappers().values():
        for fn in fns:
            fn.launches = 0
    edge_filter.calls = 0


def read_counts() -> dict:
    return {name: sum(fn.launches for fn in fns)
            for name, fns in wrappers().items()}


def edge_calls() -> int:
    from tandem_tpu_torch.ops.edge_kth import edge_filter
    return edge_filter.calls


def require_launched(path: str, counts: dict, names, at_least: int = 1):
    for name in names:
        if counts[name] < at_least:
            raise AssertionError(f"{path}: {name} launched {counts[name]} "
                                 f"< {at_least} times")


def require_edge_filter(path: str, launches: int, calls: int,
                        at_least: int):
    """The edge filter ran ``at_least`` times on this path, each call with
    the kernel launches its C call reported, KERNELS_PER_CALL of them, and
    nothing else of edge_kth.cu ran (K1 alone is off the path)."""
    from tandem_tpu_torch.ops.edge_kth import KERNELS_PER_CALL
    if calls < at_least or launches != KERNELS_PER_CALL * calls:
        raise AssertionError(f"{path}: edge_kth launched {launches} times in "
                             f"{calls} edge_filter calls (need >= {at_least} "
                             f"calls of {KERNELS_PER_CALL} launches)")


def require_not_launched(path: str, counts: dict, names):
    for name in names:
        if counts[name]:
            raise AssertionError(f"{path}: {name} launched {counts[name]} "
                                 "times; it is off this path")


def load_runner(dev, dtype):
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
    with open(UNIT / "model_config.json") as f:
        cfg = json.load(f)
    pack = np.load(UNIT / "sample_inputs.npz")
    V, H, W = pack["image"].shape[1], pack["image"].shape[3], \
        pack["image"].shape[4]
    runner = MvsnetRunner(CvaMVSNet(**cfg, dtype=dtype),
                          load_variables(UNIT / "model_variables.pkl"),
                          H, W, view_num=V, device=dev)
    return runner, pack


def _golden_forward(runner, pack, dev, scale: float = 1.0):
    """The unit's model on the golden pack (the image times ``scale``)."""
    import torch
    return runner.model(
        torch.from_numpy(pack["image"].astype(np.float32) / 255.0
                         * np.float32(scale)).to(dev),
        [torch.from_numpy(pack[k]).to(dev) for k in ("K1", "K2", "K3")],
        torch.from_numpy(pack["cam_to_world"]).to(dev),
        torch.from_numpy(pack["depth_min"]).to(dev),
        torch.from_numpy(pack["depth_max"]).to(dev),
        torch.full((1,), float(pack["discard_percentage"])))


def golden_window(pack):
    """The pack's 7 views as a runtime window: the pack is ref-first, so
    view 0 goes back to index V-2; RGB back to BGR uint8."""
    rgb = pack["image"][0]                     # (V, 3, H, W) uint8
    c2w = pack["cam_to_world"][0]
    V = rgb.shape[0]
    order = list(range(1, V - 1)) + [0, V - 1]
    bgrs = [np.ascontiguousarray(rgb[i].transpose(1, 2, 0)[..., ::-1])
            for i in order]
    return bgrs, [c2w[i] for i in order], c2w[0]


def _warp_positions(dev, gen, D: int, H: int, W: int):
    """Plane-sweep-like positions of one source view: a shifted, scaled
    pixel grid a plane with jitter, past both pad edges, and a 5%
    keep=False share for rays behind the source camera."""
    import torch
    gy, gx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    shift = torch.linspace(-4.0, 6.0, D, device=dev)[:, None, None]
    jit = torch.rand((2, D, H, W), generator=gen, device=dev) - 0.5
    x = (gx * 1.02 + shift + jit[0])[None].contiguous()
    y = (gy * 0.99 + 1.5 + jit[1])[None].contiguous()
    keep = torch.rand((1, D, H, W), generator=gen, device=dev) < 0.95
    return x, y, keep


def _golden_sweep(dev, stage: str, D: int, H: int, W: int,
                  behind: bool = False, shapes: dict = STAGE_SHAPES,
                  view: int = 1):
    """The plane sweep of the golden pack's view 0 from view ``view`` at
    one stage of ``shapes``, with the depth hypotheses as the model makes
    them; ``behind`` moves the source camera forward by the median
    hypothesis, so that about half of the sweep lies behind it. Returns
    (ref->src (1, 3, 4), depth (1, D, H, W), (K, src, ref))."""
    import torch

    from tandem_tpu_torch.models.layers import interpolate_bilinear
    from tandem_tpu_torch.models.ranges import (adaptive_depth_range,
                                                uniform_depth_range)
    from tandem_tpu_torch.ops.warp import ref_to_src_matrix
    pack = np.load(UNIT / "sample_inputs.npz")
    with open(UNIT / "model_config.json") as f:
        ratios = json.load(f)["depth_interval_ratio"]
    i = int(stage[-1]) - 1
    K = torch.from_numpy(pack[f"K{i + 1}"]).to(dev)
    K[..., :2, :] *= W / STAGE_SHAPES[stage][2]
    c2w = torch.from_numpy(pack["cam_to_world"]).to(dev)
    src, ref = c2w[:, view].clone(), c2w[:, 0].contiguous()
    D1, H1, W1, _ = shapes["stage1"]
    depth, base = uniform_depth_range(
        depth_min=torch.from_numpy(pack["depth_min"]).to(dev),
        depth_max=torch.from_numpy(pack["depth_max"]).to(dev),
        depth_num=D1, height=H1, width=W1)
    if i > 0:
        prev = torch.from_numpy(pack[f"out.stage{i}.depth_dense"]).to(dev)
        up = interpolate_bilinear(prev[..., None], H, W)[..., 0]
        depth = adaptive_depth_range(depth=up, interval=ratios[i] * base,
                                     depth_num=D)
    if behind:
        src[:, 2, 3] += float(depth.median())
    return (ref_to_src_matrix(K, src, K, ref), depth.contiguous(),
            (K, src, ref))


def _track_shapes():
    """(N, H, W, max_iter) of the tracker's levels: the 640x480 level-0
    cap, then the six 256x192 levels (the level caps of a dense
    reference, the LM iteration caps of coarse_tracker.MAX_ITERS)."""
    from tandem_tpu_torch.tracking.coarse_tracker import MAX_ITERS, _level_caps
    shapes = [(_level_caps(480, 640, True)[0], 480, 640, MAX_ITERS[0])]
    shapes += [(cap, 192 >> lvl, 256 >> lvl, MAX_ITERS[lvl])
               for lvl, cap in enumerate(_level_caps(192, 256, True))]
    return shapes


def _track_case(dev, N: int, B: int, H: int, W: int, seed: int):
    """A level's point list, planes and candidates for K6: a smooth
    textured image, points on integer pixels with a 10% invalid share and a
    5% photometric-outlier share (past the cutoff), poses within ~1 cm /
    0.6 degrees of the identity; f32/f64 ties dropped (_drop_ties)."""
    import torch

    from tandem_tpu_torch.core.pyramid import gradients
    from tandem_tpu_torch.core.se3 import se3_exp
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = (120 + 50 * np.sin(0.07 * xx) * np.cos(0.05 * yy)
           + 30 * np.sin(0.23 * xx + 1) + 20 * np.cos(0.31 * yy + 2)
           ).astype(np.float32)
    pu = rng.randint(0, W, N).astype(np.float32)
    pv = rng.randint(0, H, N).astype(np.float32)
    col = img[pv.astype(int), pu.astype(int)] + rng.normal(0, 4, N)
    col += (rng.rand(N) < 0.05) * rng.uniform(30, 80, N)
    pts = (pu, pv, rng.uniform(0.2, 0.8, N).astype(np.float32),
           col.astype(np.float32), rng.rand(N) < 0.9)
    T = se3_exp(torch.from_numpy(
        rng.uniform(-0.01, 0.01, (B, 6)).astype(np.float32)))
    aff = np.stack([1 + rng.uniform(-0.05, 0.05, B),
                    rng.uniform(-3, 3, B)], -1).astype(np.float32)
    planes = (torch.from_numpy(img),) + gradients(torch.from_numpy(img))
    K = (0.78 * W, 0.78 * W, (W - 1) / 2, (H - 1) / 2)
    case = (T.to(dev), torch.from_numpy(aff).to(dev),
            tuple(torch.from_numpy(p).to(dev) for p in pts),
            tuple(p.contiguous().to(dev) for p in planes), K)
    return _drop_ties(*case)


def _double(T, aff, pts, planes, K):
    return (T.double(), aff.double(),
            tuple(p.double() if p.is_floating_point() else p for p in pts),
            tuple(p.double() for p in planes), K)


def _drop_ties(T, aff, pts, planes, K):
    """Invalidate the points whose border or cutoff test comes out
    differently in f32 and in f64 (a residual within rounding of the
    cutoff, a projection within rounding of the border): one such point
    moves the sums by its whole term, which says nothing of the kernel's
    arithmetic. The kernel keeps the same points as the plain f32 version
    (``num`` equal) either way."""
    from tandem_tpu_torch.ops.track_reduce import CUTOFF_TH, level_residuals
    r32, _, g32, _, _ = level_residuals(T, aff, pts, planes, K)
    r64, _, g64, _, _ = level_residuals(*_double(T, aff, pts, planes, K))
    tie = ((g32 != g64) | ((r32.abs() < CUTOFF_TH)
                           != (r64.abs() < CUTOFF_TH))).any(0)
    return T, aff, pts[:4] + (pts[4] & ~tie,), planes, K


def _cast(x, dtype):
    import torch
    return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x


def _lm_compare(where, prev, got, pts, planes, K, max_iter, dtype,
                tdist: bool = False) -> dict:
    """Hold one kernel step (the state ``prev`` to ``got``) against
    lm_step_plain from ``prev`` evaluated in ``dtype`` (float64 for
    _lm_one_step; float32 along a whole level). An inactive step must leave the
    state as it was. Raises past the tolerances; returns the errors, the
    tie count and whether the step was active."""
    import torch

    from tandem_tpu_torch.core.se3 import se3_exp
    from tandem_tpu_torch.ops import track_lm as tl
    from tandem_tpu_torch.ops.track_reduce import track_reduce_plain
    if not prev.active:
        if not all(torch.equal(a, b) if torch.is_tensor(a) else a == b
                   for a, b in zip(got, prev)):
            raise AssertionError(f"{where}: an inactive step changed the "
                                 "state")
        return {"active": False, "solve": 0.0, "se3": 0.0, "se3_plain": 0.0,
                "dx": 0.0, "T_new": 0.0, "dx_plain": 0.0, "sums": 0.0,
                "ties": 0}
    p = tl.LMState(*(_cast(x, dtype) for x in prev))
    ptsd = tuple(_cast(x, dtype) for x in pts)
    planesd = tuple(_cast(x, dtype) for x in planes)
    ref = tl.lm_step_plain(p, ptsd, planesd, K, max_iter, tdist)
    e_new, n_new, _, _ = track_reduce_plain(p.T_new, p.aff_new, ptsd,
                                            planesd, K, tdist)
    e_old_n = p.e / p.n.clamp(min=1.0)
    e_new_n = e_new / n_new.clamp(min=1.0)
    margin = LM_TIE * e_old_n.clamp(min=1e-6)
    tie = ~p.done & (((e_new_n - e_old_n).abs() <= margin)
                     | ((e_old_n - e_new_n - 1e-4 * e_old_n.clamp(min=1e-6))
                        .abs() <= margin))
    ok = ~tie
    # active is any(live): a tie's done or lam may decide it either way.
    if got.it != ref.it or (got.active != ref.active and not tie.any()):
        raise AssertionError(f"{where}: it/active {got.it} {got.active} != "
                             f"{ref.it} {ref.active}")
    if not (torch.equal(got.done[ok], ref.done[ok])
            and torch.equal(got.lam[ok].to(dtype), ref.lam[ok])
            and torch.equal(got.T[ok].to(dtype), ref.T[ok])
            and torch.equal(got.n[ok].to(dtype), ref.n[ok])):
        raise AssertionError(f"{where}: done/lam/T/n differ: "
                             f"{got.done.tolist()} {got.lam.tolist()} vs "
                             f"{ref.done.tolist()} {ref.lam.tolist()} (ties "
                             f"{tie.tolist()})")

    def rel(a, b, scale=None):
        if not ok.any():
            return 0.0
        d = (a[ok].to(dtype) - b[ok]).abs()
        if scale is None:
            return float(d.max() / b[ok].abs().max().clamp(min=1e-30))
        return float((d / scale[ok].clamp(min=1e-30)).max())
    e_scale = ref.e + ref.n
    g_scale = (torch.diagonal(ref.Hm, dim1=-2, dim2=-1)
               * e_scale[:, None]).sqrt()
    errs = {"active": True, "solve": 0.0, "se3": 0.0, "se3_plain": 0.0,
            "dx": 0.0, "T_new": 0.0, "dx_plain": 0.0,
            "sums": max(rel(got.e, ref.e, e_scale), rel(got.Hm, ref.Hm),
                        rel(got.g, ref.g, g_scale)),
            "ties": int(tie.sum())}
    if ref.active:   # the next proposal
        Hk = got.Hm.double()
        eye = torch.eye(8, dtype=torch.float64, device=Hk.device)
        Hl = (Hk + got.lam.double()[:, None, None]
              * (torch.diagonal(Hk, dim1=-2, dim2=-1)[:, :, None] * eye)
              + 1e-5 * eye)
        dx, g = got.dx.double(), got.g.double()
        resid = (Hl @ dx[..., None])[..., 0] + g
        size = (Hl.abs() @ dx.abs()[..., None])[..., 0] + g.abs()
        own = se3_exp(dx[:, :6]) @ got.T.double()
        scale = own.abs().max().clamp(min=1.0)
        own32 = se3_exp(got.dx[:, :6]) @ got.T       # the plain f32 update
        step = ref.dx[ok].abs().max().clamp(min=1e-30) if ok.any() else 1.0
        errs.update(solve=float((resid.abs() / size.clamp(min=1e-300))
                                .max()),
                    se3=float((got.T_new.double() - own).abs().max()
                              / scale),
                    se3_plain=float((own32.double() - own).abs().max()
                                    / scale),
                    dx=rel(got.dx, ref.dx),
                    T_new=float((got.T_new[ok].to(dtype) - ref.T_new[ok])
                                .abs().max() / step) if ok.any() else 0.0)
        if tdist:   # the plain f32 step's own dx error against float64
            other = (torch.float32 if dtype == torch.float64
                     else torch.float64)
            alt = tl.lm_step_plain(
                tl.LMState(*(_cast(x, other) for x in prev)),
                tuple(_cast(x, other) for x in pts),
                tuple(_cast(x, other) for x in planes), K, max_iter, True)
            s32, s64 = (alt, ref) if other == torch.float32 else (ref, alt)
            both = ok & (s32.done == s64.done)
            if alt.active and both.any():
                errs["dx_plain"] = float(
                    (s32.dx[both].double() - s64.dx[both]).abs().max()
                    / s64.dx[both].abs().max().clamp(min=1e-30))
    dx_tol = max(LM_DX_TOL, LM_DX_PLAIN_X * errs["dx_plain"])
    if not (errs["solve"] <= LM_SOLVE_TOL
            and errs["se3"] <= max(LM_SE3_TOL, 4 * errs["se3_plain"])
            and max(errs["dx"], errs["T_new"]) <= dx_tol
            and errs["sums"] <= TRACK_TOL):
        raise AssertionError(f"{where}: {errs} past LM_SOLVE_TOL "
                             f"{LM_SOLVE_TOL}, LM_SE3_TOL {LM_SE3_TOL}, "
                             f"LM_DX_TOL {LM_DX_TOL} (here {dx_tol:.3e}), "
                             f"TRACK_TOL {TRACK_TOL}")
    return errs


def _lm_one_step(dev, N, B, H, W, max_iter, seed, tdist=False) -> dict:
    """A plain f32 state after one step, then one
    kernel step from it (``lm_run`` from the packed state) against
    lm_step_plain in float64."""
    import torch

    from tandem_tpu_torch.ops import track_lm as tl
    T, aff, pts, planes, K = _track_case(dev, N, B, H, W, seed)
    s = tl.lm_init_plain(T, aff, pts, planes, K, max_iter, tdist)
    s = tl.lm_step_plain(s, pts, planes, K, max_iter, tdist)
    # The points the step evaluates, without f32/f64 ties at T_new.
    pts = _drop_ties(s.T_new, s.aff_new, pts, planes, K)[2]
    _, hist, last = tl.lm_run(T, aff, pts, planes, K, max_iter, tdist,
                              state=tl.pack_state(s), it0=s.it, n_steps=1)
    # The state after the step: the recorded one, or the input where the
    # loop had already ended (its candidates that are not done step on).
    got = tl.history_state(hist, last,
                           min(tl.loop_end(hist, last, s.it, max_iter), 1),
                           s.it, max_iter)
    return _lm_compare(f"track lm (a) {'t' if tdist else 'huber'} N={N} "
                       f"{W}x{H} B={B}", s, got, pts, planes, K, max_iter,
                       torch.float64, tdist)


def _lm_level_steps(dev, case, max_iter, where, tdist) -> tuple:
    """A whole level along the kernel's own path: one launch of the
    level, whose history holds every candidate's state after every step;
    the first record against lm_init_plain, then every step up to the
    loop's end against lm_step_plain (f32, on the card) from the kernel's
    state before it; the kernel's result equal to its history's
    (``lm_level_from_history``) and its sums at the accepted poses equal to
    K6's at those poses, bit for bit. Returns the worst errors and the
    kernel's result."""
    import torch

    from tandem_tpu_torch.ops import track_lm as tl
    from tandem_tpu_torch.ops.track_reduce import track_reduce
    T, aff, pts, planes, K = case
    B = T.shape[0]
    before = tl.lm_level.launches
    out, hist, last = tl.lm_run(*case, max_iter, tdist)
    if tl.lm_level.launches != before + 1:
        raise AssertionError(f"{where}: not one launch a level")
    end = tl.loop_end(hist, last, 0, max_iter)
    prev = tl.history_state(hist, last, 0, 0, max_iter)
    ref = tl.lm_init_plain(*case, max_iter, tdist)
    if not (torch.equal(prev.T, T) and torch.equal(prev.n, ref.n)
            and torch.equal(prev.lam, ref.lam) and prev.it == ref.it
            and prev.active == ref.active):
        raise AssertionError(f"{where}: the first record differs from "
                             "lm_init_plain")
    worst = {"solve": 0.0, "se3": 0.0, "se3_plain": 0.0, "dx": 0.0,
             "T_new": 0.0, "dx_plain": 0.0, "sums": 0.0, "ties": 0}
    for k in range(end):
        got = tl.history_state(hist, last, k + 1, 0, max_iter)
        errs = _lm_compare(where, prev, got, pts, planes, K, max_iter,
                           torch.float32, tdist)
        worst = {key: max(v, errs[key]) for key, v in worst.items()}
        prev = got
    if prev.active and end < max_iter:
        raise AssertionError(f"{where}: the loop ended at step {end} with a "
                             "live candidate")
    got = tl.level_result(out, B)
    res = tl.lm_level_from_history(hist, last, T, aff, 0, max_iter)
    if not all(torch.equal(a.float(), b.float()) for a, b in zip(got, res)):
        raise AssertionError(f"{where}: the kernel's result differs from "
                             "its history's")
    k6 = track_reduce(prev.T, prev.aff, pts, planes, K, tdist=tdist)
    if not all(torch.equal(a, b) for a, b in zip(
            k6, (prev.e, prev.n, prev.Hm, prev.g))):
        raise AssertionError(f"{where}: the LM's sums at the accepted poses "
                             "differ from K6's")
    return worst, got


def _host_reads(fn) -> int:
    """The synchronizing CUDA calls of one call of ``fn``."""
    import warnings

    import torch
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in seen)


def _motion_init(ref_c2w, last_c2w, prev_c2w):
    """FullSystem._motion_model: constant velocity, as T_ref->new."""
    pred = last_c2w @ np.linalg.inv(prev_c2w) @ last_c2w
    return (np.linalg.inv(pred) @ ref_c2w).astype(np.float32)


def _track_loop(dev, scene, ref, ref_id: int, frames, tag: str):
    """Track ``frames`` one after another from the constant-motion
    prediction; return each frame's (position error m, worst rotation
    entry error) against the GT poses."""
    import torch

    from tandem_tpu_torch.tracking.coarse_tracker import track_frame
    ref_c2w = scene.c2w(ref_id).astype(np.float64)
    prev, last = scene.c2w(ref_id - 1).astype(np.float64), ref_c2w
    aff0 = torch.tensor([1.0, 0.0], device=dev)
    errs = []
    for f in frames:
        img = torch.from_numpy(scene.gray(f)).to(dev)
        T0 = torch.from_numpy(_motion_init(ref_c2w, last, prev)).to(dev)
        out = track_frame(ref, img, T0, aff0)
        T = out["T"].cpu().numpy().astype(np.float64)
        c2w = ref_c2w @ np.linalg.inv(T)
        gt = scene.c2w(f).astype(np.float64)
        errs.append((float(np.linalg.norm(c2w[:3, 3] - gt[:3, 3])),
                     float(np.abs(c2w[:3, :3] - gt[:3, :3]).max())))
        if not np.isfinite(T).all() or not np.isfinite(float(
                out["energy"])):
            raise AssertionError(f"{tag}: frame {f} pose not finite")
        prev, last = last, c2w
    return errs


def _dense_ref(dev, depth, c2w, gray, K, fx, fy, cx, cy):
    import torch

    from tandem_tpu_torch.tracking.coarse_tracker import (make_tracker_ref,
                                                          splat_depth_to_ref)
    H, W = gray.shape
    idp, w = splat_depth_to_ref(depth, c2w, c2w, K, H, W, stride=3)
    return make_tracker_ref(torch.from_numpy(gray).to(dev), fx, fy, cx, cy,
                            dense_idepth=idp, dense_weight=w)


def _slam_run(dev, out_dir: Path, mvsnet: bool, preload: bool = False,
              unit: Path = UNIT) -> dict:
    """One tandem_dataset run on the trajectory fixture (``preload``: frames
    read up front; ``unit``: its mvsnet_folder): its ATE and launches."""
    import hashlib

    import torch

    from tandem_tpu_torch.cli import tandem_dataset
    from tandem_tpu_torch.eval.ate import (associate, evaluate_ate,
                                           load_tum_trajectory, tum_to_xyz)
    argv = ["preset=dataset", f"files={FIXTURE / 'images'}",
            f"calib={FIXTURE / 'camera_dso.txt'}", f"result_folder={out_dir}",
            "dr_timing=1"]
    if mvsnet:
        argv.append(f"mvsnet_folder={unit}")
    if preload:
        argv.append("preload=1")
    torch.cuda.synchronize()
    reset_counts()
    calls0 = edge_calls()
    res = tandem_dataset.main(argv, device=dev)
    torch.cuda.synchronize()
    counts = read_counts()
    gt = load_tum_trajectory(str(FIXTURE / "gt_tum.txt"))
    est = load_tum_trajectory(str(out_dir / "result.txt"))
    matches = associate(gt, est)
    ate = evaluate_ate(tum_to_xyz(gt, [a for a, _ in matches]),
                       tum_to_xyz(est, [b for _, b in matches]),
                       with_scale=True)
    return {"res": res, "counts": counts, "edge_calls": edge_calls() - calls0,
            "pairs": len(matches), "ate": ate,
            "digest": hashlib.sha256(
                (out_dir / "result.txt").read_bytes()).hexdigest()}


def _runtime_frames(n: int, H: int, W: int):
    """A jax-free copy of bench_runtime.make_frames: the textured plane
    sequence at full resolution, uint8 grey, with its fx, cx, cy."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    fx = 0.6 * W
    cx, cy = (W - 1) / 2, (H - 1) / 2
    frames = []
    for i in range(n):
        tx = 0.015 * i
        x = (u - cx) / fx * 2.0 + tx
        y = (v - cy) / fx * 2.0
        img = (120 + 45 * np.sin(17 * x) * np.cos(13 * y)
               + 30 * np.sin(41 * x + 1) + 25 * np.cos(33 * y)
               + 15 * np.sin(77 * x * y))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames, fx, cx, cy


def _png_filtered(img: np.ndarray) -> bytes:
    """An 8-bit grey or RGB image as PNG bytes whose rows cycle through the
    Paeth, Sub, Up and Average filters (data/replica.write_png writes only
    unfiltered rows), so a decoder does the work of a real file."""
    import struct
    import zlib
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    cur = img.reshape(h, -1).astype(np.int32)
    up = np.vstack([np.zeros_like(cur[:1]), cur[:-1]])
    left = np.hstack([np.zeros_like(cur[:, :bpp]), cur[:, :-bpp]])
    ul = np.hstack([np.zeros_like(up[:, :bpp]), up[:, :-bpp]])
    pa, pb, pc = np.abs(up - ul), np.abs(left - ul), np.abs(left + up - 2 * ul)
    preds = {4: np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul)),
             1: left, 2: up, 3: (left + up) >> 1}
    ftype = np.array([4, 1, 2, 3], np.uint8)[np.arange(h) % 4]
    pred = np.empty_like(cur)
    for f, p in preds.items():
        pred[ftype == f] = p[ftype == f]
    raw = np.hstack([ftype[:, None], ((cur - pred) & 0xFF).astype(np.uint8)])

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    hdr = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_runtime_sequence(root: Path, n: int = RUNTIME_FRAMES,
                           H: int = 480, W: int = 640) -> dict:
    """The runtime test's sequence on disk: images/%06d.png (RGB, the
    grey replicated, filtered rows), camera.txt and gt_tum.txt (the camera
    at x = 0.015 i, stamps i / 30 as the reader gives without times.txt)."""
    from tandem_tpu_torch.pipeline.io import write_result_tum
    frames, fx, cx, cy = _runtime_frames(n, H, W)
    (root / "images").mkdir(parents=True)
    for i, g in enumerate(frames):
        (root / "images" / f"{i:06d}.png").write_bytes(
            _png_filtered(np.repeat(g[..., None], 3, -1)))
    (root / "camera.txt").write_text(f"Pinhole {fx} {fx} {cx} {cy} 0\n"
                                     f"{W} {H}\n")
    poses = []
    for i in range(n):
        c2w = np.eye(4)
        c2w[0, 3] = 0.015 * i
        poses.append(c2w)
    write_result_tum(str(root / "gt_tum.txt"), [i / 30.0 for i in range(n)],
                     poses)
    return {"frames": frames, "fx": fx}


def _rgbd_run(dev, out_dir: Path, unit: bool, frames: int = 64) -> dict:
    """FullSystem(rgbd=True) through the API on the trajectory fixture's
    frames and sensor depths (depths/*.png, scale 0.0002), with the dataset
    preset as tandem_dataset builds it (``unit``: the trained abl04 unit,
    bf16, in the backend): its SE(3) ATE without scale and the launches of
    each kernel."""
    import hashlib

    import torch

    from tandem_tpu_torch.cli.golden import load_model_config
    from tandem_tpu_torch.data.reader import RGBDReader
    from tandem_tpu_torch.eval.ate import (associate, evaluate_ate,
                                           load_tum_trajectory, tum_to_xyz)
    from tandem_tpu_torch.mapping.tsdf import TsdfConfig
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    from tandem_tpu_torch.pipeline.full_system import (
        FullSystem, make_full_system_options)
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
    from tandem_tpu_torch.settings import parse_arguments, preset
    s = parse_arguments(["rgbd=1"], base=preset("dataset"))
    fx, fy, cx, cy, W, H = 200.0, 200.0, 127.5, 95.5, 256, 192
    K_mat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    backend = None
    if unit:
        model = CvaMVSNet(**load_model_config(str(UNIT)),
                          dtype=torch.bfloat16)
        runner = MvsnetRunner(model, load_variables(
            str(UNIT / "model_variables.pkl")), H, W,
            view_num=s.dr_mvsnet_view_num, device=dev)
        backend = TandemBackend(runner, TsdfConfig(), K_mat, H, W,
                                mesh_extraction_freq=s.mesh_extraction_freq)
    fs = FullSystem(fx, fy, cx, cy, H, W, options=make_full_system_options(s),
                    backend=backend, device=dev)
    reader = RGBDReader(str(FIXTURE / "images"),
                        depth_path=str(FIXTURE / "depths"),
                        depth_scale=2e-4)
    torch.cuda.synchronize()
    reset_counts()
    calls0 = edge_calls()
    for i in range(frames):
        gray, ts, _ = reader.get_image(i)
        fs.add_active_frame(gray, i, ts, bgr=reader.get_image_bgr(i),
                            depth=reader.get_depth(i))
        if fs.is_lost:
            raise AssertionError(f"rgbd: lost at frame {i}")
    torch.cuda.synchronize()
    counts = read_counts()
    fs.write_results(str(out_dir))
    gt = load_tum_trajectory(str(FIXTURE / "gt_tum.txt"))
    est = load_tum_trajectory(str(out_dir / "result.txt"))
    pairs = associate(gt, est)
    ate = evaluate_ate(tum_to_xyz(gt, [a for a, _ in pairs]),
                       tum_to_xyz(est, [b for _, b in pairs]),
                       with_scale=False)
    lines = (out_dir / "result.txt").read_bytes().splitlines(True)
    return {"fs": fs, "backend": backend, "counts": counts,
            "edge_calls": edge_calls() - calls0, "pairs": len(pairs),
            "ate": ate, "frames": frames,
            "digest": hashlib.sha256(b"".join(lines)).hexdigest(),
            "digest_48": hashlib.sha256(b"".join(lines[:48])).hexdigest()}


def _train_cli(dev, out_dir: Path, pretrained: str = None,
               *overrides) -> dict:
    """One run of the port's tandem_train CLI on the trajectory fixture
    (abl04 config, 640x480, B = 2, one epoch, on the card): its result and
    the kernel launches of the run."""
    import torch

    from tandem_tpu_torch.cli import tandem_train
    argv = [str(out_dir), "--config", str(ABL04_CONFIG),
            *(["--pretrained", pretrained] if pretrained else []),
            "DATA.ROOT_DIR", str(TRAIN_ROOT), "TRAIN.EPOCHS", "1",
            "IO.LOG_INTERVAL", "1", *overrides]
    torch.cuda.synchronize()
    reset_counts()
    res = tandem_train.main(tandem_train.parser.parse_intermixed_args(argv))
    torch.cuda.synchronize()
    return {"res": res, "counts": read_counts()}


def _require_step_launches(path: str, counts: dict, steps: int,
                           per_step: int):
    """The forward sample and its backward kernel launched in every step:
    once a source view and stage each."""
    if counts["warp_sample_grad"] != per_step * steps \
            or counts["bilinear_sample"] < per_step * steps:
        raise AssertionError(f"{path}: {counts['bilinear_sample']} sample "
                             f"and {counts['warp_sample_grad']} backward "
                             f"launches in {steps} steps (want "
                             f"{per_step} each a step)")


def _recorded_step(step, state, batch):
    """One train step with every backward-kernel call's inputs and float32
    sums recorded: (state, metrics, the calls)."""
    from tandem_tpu_torch.ops import bilinear_sample as bs
    kernel, calls = bs.warp_sample_grad, []

    def recording(grad_out, ref_to_src, depth, min_depth_thres=0.001):
        acc = kernel(grad_out, ref_to_src, depth, min_depth_thres)
        calls.append((grad_out.clone(), ref_to_src.clone(), depth.clone(),
                      min_depth_thres, acc.clone()))
        return acc
    recording.launches = 0
    bs.warp_sample_grad = recording
    try:
        state, m = step(state, batch)
    finally:
        bs.warp_sample_grad = kernel
        kernel.launches += recording.launches
    return state, m, calls


def _runner_outputs(runner, pack) -> dict:
    """One runner call on the golden pack's window, as numpy."""
    bgrs, poses, _ = golden_window(pack)
    runner.call_async(bgrs, poses, pack["K3"][0],
                      float(pack["depth_min"][0]), float(pack["depth_max"][0]),
                      float(pack["discard_percentage"]))
    return runner.get_result()
