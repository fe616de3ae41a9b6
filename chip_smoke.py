#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: the keyframe map path in
float32 and in bfloat16 (the JAX package's deployed dtype), and the dense
coarse tracker tracking against the TSDF model.

    python3 chip_smoke.py                    # from the root of a checkout
    python3 chip_smoke.py --profile-dir DIR  # + a torch.profiler table of
                                             #   one keyframe per dtype (and
                                             #   its device events) and of
                                             #   one track_frame at 640x480,
                                             #   traces in DIR

Phases, each printing its numbers before the last line:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    compile the CUDA kernels of tandem_tpu_torch/csrc/ (one nvcc
              per source, in parallel) and print ptxas's register report;
  3. kernels  each hand kernel against its plain PyTorch version on the
              card, exact (torch.equal), with both times: K1 edge_kth;
              P5 bilinear_index and P3 corner_blend in f32 and bf16 at
              the three stage shapes of abl04 640x480; the plane-sweep
              sample bilinear_sample (csrc/bilinear_sample.cu) at the same
              six points: warp_sample on the golden pack's view 0 <- 1
              sweep (and with the source camera in front of the near
              hypotheses, so part of the sweep lies behind it), and
              bilinear_sample on given positions, with its CUDA event and
              profiler device times, its bound, the old path (positions,
              pack_corners, P5, P3) and grid_sample on the same positions
              by both clocks, and the wrapper's host cost per call;
              row_gather, also at P4's shape;
  4. track kernels  K6 track_reduce against a float64 evaluation of its
              plain version at the tracker's level caps (640x480 level 0,
              the six 256x192 levels) for B = 1, 5, 15 candidates, within
              TRACK_TOL of the largest |entry|; num equal to the plain
              f32 version's; both times;
     track lm  the LM kernel track_lm at the same caps and B: (a) one step
              from a plain state against lm_step_plain in float64 (dx, T_new
              and the sums within their LM_* tolerances and TRACK_TOL; dx's
              backward error in its own system; it, active, accept,
              done and lam equal except at ties within LM_TIE); (b) whole
              levels: every launch against the plain f32 step from the
              kernel's own state, lm_level equal to its steps bit for bit,
              the end point against lm_level_plain on the card (pose within
              LM_POSE_PX pixels of the level, aff within LM_AFF_TOL, unless
              the paths parted at a near-tie, never at the 640x480 cap),
              iteration counts, both times; and the level's time for each
              CHECK_EVERY;
  5. probes   the torch ports of the three Pallas probe scripts at their
              own shapes (tandem_tpu_torch/experiments), M rows/s;
  6. golden   the trained abl04 unit (exported/tandem, 640x480, V=7)
              replays sample_inputs.npz in f32: worst MAE < 1e-2 over all
              12 outputs, the reference's own boot-check bar;
              bilinear_sample and K1 must have launched, and P5 and P3,
              off the main path, not (slice and track mvs hold the same);
  7. slice    TandemBackend (MvsnetRunner + TSDF allocate, integrate,
              culled splat render) runs 4 keyframes built from the golden
              views in f32; the rendered depth must agree with the MVSNet
              depth; per-keyframe times;
  8. track 640x480  (times only) the dense reference built on golden view 0
              from the f32 slice's rendered depth; track_frame on views
              1-6, track_frame_multi with 5 motion candidates and with the
              15 rotation perturbations: ms per frame and LM iterations;
  9. culled   on the f32 slice's map and on the wall scene at 640x480,
              integrate_culled and both culled renders equal the full walk
              (torch.equal) at turned cameras; counts and both times;
 10. golden and slice again in bf16: worst MAE < 1e-1 (10 x the bar, the
              JAX runtime's bf16 boot check), the same render contract;
 11. wall     the TSDF wall contract at 640x480;
 12. track gt tests/fixtures/replica_traj (256x192): GT depths 0-6 fused,
              the axis-culled render at frame 6, frames 7-14 tracked from
              the constant-motion prediction: worst position error < 5 mm;
 13. track mvs the map from TandemBackend on the fixture's first two 7-view
              windows (trained abl04, f32), the reference at frame 10, the
              8 frames after it tracked: worst position error within
              MVS_TRACK_BOUND; K1, bilinear_sample, K6 and track_lm must
              have launched.
The launch counters are set to 0 just before each driven path (the probes,
the slices, the three tracking paths) and read just after it. The last line
of stdout is the JSON result; any failed phase exits non-zero without it.
The line before it lists every kernel with its launches on the driven
paths, its error and time against its plain version, its bound (the
larger of its bytes over HBM_BYTES_PER_S and its operations over
F32_OPS_PER_S, from this run's inputs) and, where one PyTorch call
computes the same function, that call's time (``library_ms``; the port
never calls it).
Without a CUDA device, or without the repository beside this script, it
fails at once. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
UNIT = REPO / "exported" / "tandem"
GOLDEN_TOL = 1e-2
BF16_TOL = 10 * GOLDEN_TOL   # tandem_tpu/cli/tandem_dataset.py:107-108
N_KEYFRAMES = 4
FIXTURE = REPO / "tests" / "fixtures" / "replica_traj" / "scene0"
# K6 against float64: relative to the largest |entry| of each output. The
# f32 sums of up to 42,496 x 15 terms stay near 1e-6; a point whose border
# or cutoff test flips between f32 and f64 moves the energy by <= 400 of
# ~10^6.
TRACK_TOL = 1e-4
GT_TRACK_BOUND = 5e-3        # m; the JAX package gets ~1 mm on this loop
# m; 1.5 x the JAX package's worst error on the same loop on the CPU
# (tests/test_torch_tracker.py::test_track_against_the_mvs_model).
MVS_TRACK_BOUND = 0.0532
# track_lm, one step against float64 (phase track lm (a)). dx must solve
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
# Bounds: NVIDIA's H100 SXM data sheet.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12        # f32 outside the tensor cores
# K6's work per (valid point, candidate): projection ~20, bilinear sample
# of three planes ~30, residual and Huber ~10, Jacobian ~20, the 44 sums of
# H and g ~100 operations.
TRACK_OPS = 180
# K1's work per pixel: 25 differences and 25 |.|, and n log2 n ~ 116
# comparisons to order the 25 values.
EDGE_OPS = 166
# The plane-sweep sample's work per sample, besides 7 per channel for the
# blend: ~15 for the projection and its two divisions, ~15 for the floor,
# the weights and the in-bounds test, ~10 for the corner addresses.
SAMPLE_OPS = 40
# abl04 at 640x480: per stage (depth planes, H, W, feature channels).
STAGE_SHAPES = {"stage1": (48, 120, 160, 32), "stage2": (4, 240, 320, 16),
                "stage3": (4, 480, 640, 8)}
# Every hand kernel: where it lives and which Pallas kernels it replaces.
KERNELS = {
    "edge_kth": ("tandem_tpu_torch/csrc/edge_kth.cu",
                 "tandem_tpu/ops/pallas_kernels.py:59"),
    "bilinear_index": ("tandem_tpu_torch/csrc/bilinear_index.cu",
                       "experiments/bench_idxchain.py:62"),
    "corner_blend": ("tandem_tpu_torch/csrc/corner_blend.cu",
                     "experiments/pallas_gather_probe.py:82"),
    "bilinear_sample": ("tandem_tpu_torch/csrc/bilinear_sample.cu",
                        "experiments/bench_idxchain.py:62 + "
                        "experiments/pallas_gather_probe.py:82 (P5 + P3) "
                        "on the main path, and the position math of "
                        "tandem_tpu/ops/warp.py:96-116 (XLA)"),
    "row_gather": ("tandem_tpu_torch/csrc/row_gather.cu",
                   "experiments/pallas_gather_probe.py:35 "
                   "experiments/pallas_gather_probe.py:59 "
                   "experiments/pallas_shuffle_probe.py:25"),
    "track_reduce": ("tandem_tpu_torch/csrc/track_reduce.cu",
                     "tandem_tpu/tracking/coarse_tracker.py:348 "
                     "(_energy_and_system: XLA code, not a Pallas kernel)"),
    "track_lm": ("tandem_tpu_torch/csrc/track_lm.cu",
                 "tandem_tpu/tracking/coarse_tracker.py:382 _lm_level + "
                 ":348 _energy_and_system (XLA, not Pallas)"),
}


def log(msg: str):
    print(msg, flush=True)


def wrappers() -> dict:
    """Each kernel's wrappers; their ``.launches`` count its launches."""
    from tandem_tpu_torch.ops.bilinear_index import bilinear_index
    from tandem_tpu_torch.ops.bilinear_sample import (bilinear_sample,
                                                      warp_sample)
    from tandem_tpu_torch.ops.corner_blend import corner_blend
    from tandem_tpu_torch.ops.edge_kth import edge_kth_value
    from tandem_tpu_torch.ops.row_gather import row_gather
    from tandem_tpu_torch.ops.track_lm import lm_level
    from tandem_tpu_torch.ops.track_reduce import track_reduce
    return {"edge_kth": (edge_kth_value,), "bilinear_index": (bilinear_index,),
            "corner_blend": (corner_blend,),
            "bilinear_sample": (warp_sample, bilinear_sample),
            "row_gather": (row_gather,), "track_reduce": (track_reduce,),
            "track_lm": (lm_level,)}


def reset_counts():
    for fns in wrappers().values():
        for fn in fns:
            fn.launches = 0


def read_counts() -> dict:
    return {name: sum(fn.launches for fn in fns)
            for name, fns in wrappers().items()}


def require_launched(path: str, counts: dict, names, at_least: int = 1):
    for name in names:
        if counts[name] < at_least:
            raise AssertionError(f"{path}: {name} launched {counts[name]} "
                                 f"< {at_least} times")


def require_not_launched(path: str, counts: dict, names):
    for name in names:
        if counts[name]:
            raise AssertionError(f"{path}: {name} launched {counts[name]} "
                                 "times; it is off this path")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the f32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def phase_device():
    import torch

    from tandem_tpu_torch.utils.cuda_timing import card_label
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    log(card_label())
    return name


def phase_build():
    from tandem_tpu_torch.ops import _build
    secs = _build.build()
    lib = _build.library_path()
    log(f"[build] csrc/*.cu -> {lib.relative_to(REPO)} in {secs:.2f} s")
    report = lib.parent / "ptxas.log"
    if report.exists():
        for line in report.read_text().splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"[build] {line.strip()}")
    _build.kernels()


def _exact(name: str, got, ref) -> float:
    """Hold a kernel's output(s) against the plain version's: equal, or
    raise. Returns the max |difference| (0.0)."""
    import torch
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((a.float() - b.float()).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, ref))
    if not all(torch.equal(a, b) for a, b in zip(got, ref)):
        raise AssertionError(f"{name} differs from plain: max |err| {err}")
    return err


def _edge_kth(dev, out: dict):
    import torch

    from tandem_tpu_torch.ops.edge_kth import edge_kth_plain, edge_kth_value
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    rng = np.random.RandomState(0)
    cases = {
        "1x480x640": (rng.rand(1, 480, 640) * 4).astype(np.float32),
        "3x96x128": (rng.rand(3, 96, 128) * 4).astype(np.float32),
        "tied_1x480x640": (np.round(rng.rand(1, 480, 640) * 4) / 2
                           ).astype(np.float32),
    }
    err = 0.0
    for name, arr in cases.items():
        d = torch.from_numpy(arr).to(dev)
        e = _exact(f"K1 at {name}", edge_kth_value(d), edge_kth_plain(d))
        err = max(err, e)
        log(f"[kernels] edge_kth {name}: exact (max_abs_err {e})")
    d = torch.from_numpy(cases["1x480x640"]).to(dev)
    ms = cuda_ms(lambda: edge_kth_value(d), iters=50)
    plain_ms = cuda_ms(lambda: edge_kth_plain(d), iters=20)
    bound = _bound(2 * _nbytes(d), EDGE_OPS * d.numel())
    log(f"[kernels] edge_kth 1x480x640: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms (CUDA events, median); bound {bound}")
    out["edge_kth"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       **bound, "library_ms": None}


def _warp_positions(dev, gen, D: int, H: int, W: int):
    """Plane-sweep-like positions of one source view: a shifted, slightly
    scaled pixel grid per depth plane (neighbouring samples read
    neighbouring rows, as in the warp) with jitter, running past both pad
    edges; a 5% random keep=False share stands in for rays behind the
    source camera."""
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


def _grid_sample_args(feat, x, y, keep, H: int, W: int):
    """The P5 + P3 pair's function as one torch.nn.functional.grid_sample
    call (bilinear, align_corners=True, zeros padding): NCHW features and
    a normalised grid, with the dropped samples moved outside the image."""
    import torch
    gx = torch.where(keep, x / (W - 1) * 2 - 1, torch.full_like(x, -3.0))
    gy = torch.where(keep, y / (H - 1) * 2 - 1, torch.full_like(y, -3.0))
    grid = torch.stack([gx, gy], -1).reshape(1, -1, W, 2).to(feat.dtype)
    return feat.permute(0, 3, 1, 2).contiguous(), grid


def _sample_kernels(dev, out: dict):
    """P5 and P3 at the abl04 640x480 stage shapes, f32 and bf16, and the
    one PyTorch call that computes the pair, grid_sample."""
    import torch
    import torch.nn.functional as F

    from tandem_tpu_torch.ops.bilinear_index import (bilinear_index,
                                                     bilinear_index_plain)
    from tandem_tpu_torch.ops.corner_blend import (corner_blend,
                                                   corner_blend_plain)
    from tandem_tpu_torch.ops.bilinear_sample import pack_corners
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    gen = torch.Generator(device=dev).manual_seed(1)
    res = {"bilinear_index": {"max_abs_err": 0.0},
           "corner_blend": {"max_abs_err": 0.0}}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for stage, (D, H, W, C) in STAGE_SHAPES.items():
            x, y, keep = _warp_positions(dev, gen, D, H, W)
            args = (x, y, H, W, keep, 1, dtype)
            rows, w = bilinear_index(*args)
            e5 = _exact(f"P5 {dn} {stage}", (rows, w),
                        bilinear_index_plain(*args))
            feat = torch.randn((1, H, W, C), generator=gen, device=dev)
            table = pack_corners(feat.to(dtype)).reshape(-1, 4 * C)
            bargs = (table, rows.reshape(-1), w.reshape(4, -1))
            e3 = _exact(f"P3 {dn} {stage}", corner_blend(*bargs),
                        corner_blend_plain(*bargs))
            t5 = (cuda_ms(lambda: bilinear_index(*args)),
                  cuda_ms(lambda: bilinear_index_plain(*args)))
            t3 = (cuda_ms(lambda: corner_blend(*bargs)),
                  cuda_ms(lambda: corner_blend_plain(*bargs)))
            gs = _grid_sample_args(feat.to(dtype), x, y, keep, H, W)

            def library():
                return F.grid_sample(*gs, mode="bilinear",
                                     padding_mode="zeros", align_corners=True)
            # The same function, to the rounding of the normalised grid
            # (x / (W - 1) * 2 - 1 and back moves a sample by ~1e-5 px:
            # 2.8e-5 of the largest |feature| at stage 1 on the card).
            if dtype == torch.float32:
                lib_err = float((library().reshape(C, -1).t()
                                 - corner_blend(*bargs)).abs().max())
                if not lib_err <= 2e-4 * float(feat.abs().max()):
                    raise AssertionError(f"grid_sample differs from P5 + P3 "
                                         f"at {stage}: {lib_err}")
            lib_ms = cuda_ms(library)
            n = rows.numel()
            b5 = _bound(_nbytes(x, y, keep, rows, w), 20 * n)
            b3 = _bound(_nbytes(*bargs) + n * C * table.element_size(),
                        8 * n * C)
            log(f"[kernels] {stage} {dn} N={n} C={C}: bilinear_index exact, "
                f"kernel {t5[0]:.4f} ms plain {t5[1]:.4f} ms bound "
                f"{b5['bound_ms']:.4f} ms ({b5['bound_by']}); corner_blend "
                f"exact, kernel {t3[0]:.4f} ms plain {t3[1]:.4f} ms bound "
                f"{b3['bound_ms']:.4f} ms ({b3['bound_by']}); the pair "
                f"{t5[0] + t3[0]:.4f} ms, grid_sample {lib_ms:.4f} ms")
            for name, e, t, b in (("bilinear_index", e5, t5, b5),
                                  ("corner_blend", e3, t3, b3)):
                r = res[name]
                r["max_abs_err"] = max(r["max_abs_err"], e)
                if stage == "stage1" and dtype == torch.bfloat16:
                    # grid_sample computes the pair: its time stands
                    # beside each of the two kernels.
                    r.update(ms=t[0], plain_ms=t[1], library_ms=lib_ms,
                             library="grid_sample (the P5 + P3 pair)", **b)
    out.update(res)


def _golden_sweep(dev, stage: str, D: int, H: int, W: int,
                  behind: bool = False):
    """The plane sweep of the golden pack's view 0 (reference) from view 1
    (source) at one abl04 stage: the stage's intrinsics, and the depth
    hypotheses as the model makes them (uniform at stage 1; adaptive
    around the pack's upsampled depth of the stage before after it).
    ``behind`` moves the source camera forward by the median hypothesis,
    so that about half of the sweep lies behind it. Returns the ref->src
    matrix (1, 3, 4), the depth (1, D, H, W) and the cameras (K, src,
    ref)."""
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
    c2w = torch.from_numpy(pack["cam_to_world"]).to(dev)
    src, ref = c2w[:, 1].clone(), c2w[:, 0].contiguous()
    D1, H1, W1, _ = STAGE_SHAPES["stage1"]
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


def _device_ms(fn, calls: int = 5) -> float:
    """torch.profiler's device time of one call of ``fn``: the kernels and
    copies of ``calls`` calls, summed, over the calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof
    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.self_device_time_total for e in p.key_averages()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / 1e3 / calls


def _host_us(fn, calls: int = 500) -> float:
    """Host time of one call of ``fn`` (time.perf_counter over ``calls``
    calls, no sync between them: the device runs behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    return secs / calls * 1e6


def _old_sample(feat, mat, depth):
    """The warp's sample before the one-launch kernel: the positions in
    torch, pack_corners, P5, P3."""
    from tandem_tpu_torch.ops.bilinear_index import bilinear_index
    from tandem_tpu_torch.ops.bilinear_sample import (pack_corners,
                                                      sweep_positions)
    from tandem_tpu_torch.ops.corner_blend import corner_blend
    B, H, W, C = feat.shape
    px, py, z = sweep_positions(mat, depth, H, W)
    rows, w = bilinear_index(px, py, H, W, keep=~(z < 0.001), batches=B,
                             dtype=feat.dtype)
    table = pack_corners(feat).reshape(-1, 4 * C)
    out = corner_blend(table, rows.reshape(-1), w.reshape(4, -1))
    return out.reshape(*px.shape, C)


def _host_cost(dev, feat, mat, depth, cams, library) -> dict:
    """The wrapper's host cost per call and its parts: the ctypes call
    alone, ``_build.launch`` (device and stream lookup + the call), the
    checks, the output's allocation (and its free), the whole wrapper;
    grid_sample's, for comparison; and plane_sweep_warp (the 4x4 matrices
    + the wrapper), with and without the reference's matrix passed in."""
    import torch

    from tandem_tpu_torch.ops import _build
    from tandem_tpu_torch.ops import bilinear_sample as bs
    from tandem_tpu_torch.ops.warp import plane_sweep_warp, ref_pixel_to_world
    B, H, W, C = feat.shape
    D = depth.shape[1]
    buf = torch.empty((B, D, H, W, C), dtype=feat.dtype, device=dev)
    args = (bs._SWEEP_ARGS.pack(
        feat.data_ptr(), mat.data_ptr(), depth.data_ptr(), buf.data_ptr(),
        B, D, H, W, C, *bs._plan(B, D, H, W, C, feat.element_size(),
                                 feat.data_ptr() % 16, 0),
        int(feat.dtype == torch.bfloat16), 0.001),)
    raw = _build.kernels().tandem_warp_sample
    stream = torch.cuda.current_stream().cuda_stream
    K, src, ref = cams
    p2w = ref_pixel_to_world(K, ref)

    def sweep(**kw):
        return plane_sweep_warp(feat, depth, src_K=K, src_cam_to_world=src,
                                ref_K=K, ref_cam_to_world=ref,
                                with_mask=False, **kw)
    return {
        "ctypes call": _host_us(lambda: raw(*args, stream)),
        "_build.launch": _host_us(
            lambda: _build.launch("tandem_warp_sample", dev, *args)),
        "checks": _host_us(lambda: bs._check("warp_sample", feat,
                                             (mat, depth))),
        "output allocation": _host_us(lambda: feat.new_empty(buf.shape)),
        "warp_sample": _host_us(lambda: bs.warp_sample(feat, mat, depth)),
        "grid_sample": _host_us(library),
        "plane_sweep_warp": _host_us(sweep),
        "plane_sweep_warp with the stage's ref_p2w": _host_us(
            lambda: sweep(ref_p2w=p2w))}


def _sweep_kernels(dev, out: dict):
    """csrc/bilinear_sample.cu in its two modes against its plain versions
    at the abl04 640x480 stage shapes, f32 and bf16, with the times of the
    kernel, its plain version, the old path and grid_sample."""
    import torch
    import torch.nn.functional as F

    from tandem_tpu_torch.ops.bilinear_sample import (bilinear_sample,
                                                      bilinear_sample_plain,
                                                      sweep_positions,
                                                      warp_sample,
                                                      warp_sample_plain)
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    gen = torch.Generator(device=dev).manual_seed(3)
    res = {"max_abs_err": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for stage, (D, H, W, C) in STAGE_SHAPES.items():
            feat = torch.randn((1, H, W, C), generator=gen,
                               device=dev).to(dtype)
            for behind in (True, False):    # the main case stays in mat
                mat, depth, cams = _golden_sweep(dev, stage, D, H, W, behind)
                got = warp_sample(feat, mat, depth)
                res["max_abs_err"] = max(res["max_abs_err"], _exact(
                    f"warp_sample {dn} {stage} behind={behind}", got,
                    warp_sample_plain(feat, mat, depth)))
                if behind:
                    z = sweep_positions(mat, depth, H, W)[2]
                    dropped = float((z < 0.001).float().mean())
            x, y, keep = (a.reshape(1, -1)
                          for a in _warp_positions(dev, gen, D, H, W))
            res["max_abs_err"] = max(res["max_abs_err"], _exact(
                f"bilinear_sample {dn} {stage}",
                bilinear_sample(feat, x, y, keep),
                bilinear_sample_plain(feat, x, y, keep)))
            px, py, z = sweep_positions(mat, depth, H, W)
            gs = _grid_sample_args(feat, px, py, ~(z < 0.001), H, W)

            def library():
                return F.grid_sample(*gs, mode="bilinear",
                                     padding_mode="zeros", align_corners=True)
            if dtype == torch.float32:   # the same function (see P5 + P3)
                lib_err = float((library().reshape(C, -1).t()
                                 - got.reshape(-1, C)).abs().max())
                if not lib_err <= 2e-4 * float(feat.abs().max()):
                    raise AssertionError(f"grid_sample differs from "
                                         f"warp_sample at {stage}: {lib_err}")

            def kernel():
                return warp_sample(feat, mat, depth)
            # Rounds of 20 calls: where the host dispatch is the longer,
            # the events read its steady rate, not a round's first call.
            t = {"kernel": cuda_ms(kernel, iters=100),
                 "plain": cuda_ms(lambda: warp_sample_plain(feat, mat, depth),
                                  iters=10),
                 "old": cuda_ms(lambda: _old_sample(feat, mat, depth)),
                 "grid_sample": cuda_ms(library, iters=100),
                 "given positions": cuda_ms(
                     lambda: bilinear_sample(feat, x, y, keep), iters=100)}
            dev_ms = {"kernel": _device_ms(kernel),
                      "old": _device_ms(lambda: _old_sample(feat, mat, depth)),
                      "grid_sample": _device_ms(library)}
            bound = _bound(_nbytes(feat, mat, depth, got),
                           got.numel() // C * (SAMPLE_OPS + 7 * C))
            log(f"[kernels] warp_sample {stage} {dn} D={D} {W}x{H} C={C}: "
                f"exact (and behind the source camera, {dropped:.1%} of the "
                f"samples dropped; bilinear_sample on given positions "
                f"exact); kernel {t['kernel']:.4f} ms (events) "
                f"{dev_ms['kernel']:.4f} ms (device), bound "
                f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}): share "
                f"{bound['bound_ms'] / dev_ms['kernel']:.1%} of the device "
                f"time; plain {t['plain']:.4f} ms; old path (positions, "
                f"pack_corners, P5, P3) {t['old']:.4f} ms (events) "
                f"{dev_ms['old']:.4f} ms (device); grid_sample on the "
                f"positions {t['grid_sample']:.4f} ms (events) "
                f"{dev_ms['grid_sample']:.4f} ms (device); bilinear_sample "
                f"on given positions {t['given positions']:.4f} ms (events)")
            if stage == "stage2" and dtype == torch.float32:
                host = _host_cost(dev, feat, mat, depth, cams, library)
                log("[kernels] host cost a call (perf_counter, 500 calls, "
                    "stage 2 f32): " + ", ".join(
                        f"{k} {v:.2f} us" for k, v in host.items()))
            if stage == "stage1" and dtype == torch.bfloat16:
                res.update(ms=t["kernel"], plain_ms=t["plain"],
                           device_ms=dev_ms["kernel"],
                           library_ms=t["grid_sample"],
                           library="grid_sample on the warp's positions",
                           **bound)
    out["bilinear_sample"] = res


def _row_gather(dev, out: dict):
    import torch

    from tandem_tpu_torch.experiments.gather_probe import CW, M, N_FULL
    from tandem_tpu_torch.ops.row_gather import row_gather, row_gather_plain
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    gen = torch.Generator(device=dev).manual_seed(2)
    idx = torch.randint(0, M, (N_FULL,), generator=gen, device=dev,
                        dtype=torch.int32)
    err = 0.0
    for dtype, width in ((torch.float32, CW), (torch.bfloat16, 33),
                         (torch.bfloat16, CW)):
        tbl = torch.randn((M, width), generator=gen, device=dev).to(dtype)
        err = max(err, _exact(f"row_gather {dtype} width {width}",
                              row_gather(tbl, idx), row_gather_plain(tbl, idx)))
    ms = cuda_ms(lambda: row_gather(tbl, idx))   # the (M, CW) bf16 table
    plain_ms = cuda_ms(lambda: row_gather_plain(tbl, idx))
    idx64 = idx.long()
    lib_ms = cuda_ms(lambda: torch.index_select(tbl, 0, idx64))
    bound = _bound(_nbytes(tbl, idx) + N_FULL * CW * tbl.element_size(), 0)
    log(f"[kernels] row_gather ({M}, {CW}) bf16 N={N_FULL}: exact in f32 "
        f"and bf16 (and width 33); kernel {ms:.4f} ms plain {plain_ms:.4f} "
        f"ms index_select {lib_ms:.4f} ms; bound {bound}")
    # P4's own shape: G chunks of the (M, 64) bf16 table's rows.
    from tandem_tpu_torch.experiments.shuffle_probe import G
    idx4 = torch.randint(0, M, (G * M,), generator=gen, device=dev,
                         dtype=torch.int32)
    p4 = {"kernel": cuda_ms(lambda: row_gather(tbl, idx4)),
          "plain": cuda_ms(lambda: row_gather_plain(tbl, idx4)),
          "index_select": cuda_ms(lambda: torch.index_select(
              tbl, 0, idx4.long()))}
    b4 = _bound(_nbytes(tbl, idx4) + G * M * CW * tbl.element_size(), 0)
    _exact("row_gather at P4's shape", row_gather(tbl, idx4),
           row_gather_plain(tbl, idx4))
    log(f"[kernels] row_gather at P4's shape ({G} x {M} rows of ({M}, {CW}) "
        f"bf16): exact; kernel {p4['kernel']:.4f} ms, bound "
        f"{b4['bound_ms']:.4f} ms ({b4['bound_by']}): share "
        f"{b4['bound_ms'] / p4['kernel']:.1%}; plain {p4['plain']:.4f} ms; "
        f"index_select {p4['index_select']:.4f} ms (CUDA events)")
    out["row_gather"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         **bound, "library_ms": lib_ms,
                         "library": "torch.index_select"}


def phase_kernels(dev) -> dict:
    out = {}
    _edge_kth(dev, out)
    _sample_kernels(dev, out)
    _sweep_kernels(dev, out)
    _row_gather(dev, out)
    return out


def phase_probes() -> dict:
    from tandem_tpu_torch.experiments import (gather_probe, idxchain_probe,
                                              shuffle_probe)
    reset_counts()
    for probe in (gather_probe, shuffle_probe, idxchain_probe):
        log(f"[probes] {probe.__name__}")
        probe.main()
    counts = read_counts()
    require_launched("probes", counts,
                     ("row_gather", "corner_blend", "bilinear_index"))
    return counts


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


def phase_golden(runner, pack, dev, tol: float) -> float:
    import torch
    dn = str(runner.dtype).split(".")[-1]
    before = read_counts()
    t0 = time.perf_counter()
    out = runner.model(
        torch.from_numpy(pack["image"].astype(np.float32) / 255.0).to(dev),
        [torch.from_numpy(pack[k]).to(dev) for k in ("K1", "K2", "K3")],
        torch.from_numpy(pack["cam_to_world"]).to(dev),
        torch.from_numpy(pack["depth_min"]).to(dev),
        torch.from_numpy(pack["depth_max"]).to(dev),
        torch.full((1,), float(pack["discard_percentage"])))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = read_counts()
    worst, worst_key = 0.0, ""
    for s in ("stage1", "stage2", "stage3"):
        for f in ("depth", "confidence", "depth_dense", "confidence_dense"):
            got = getattr(getattr(out, s), f)
            if got.dtype != torch.float32:
                raise AssertionError(f"golden {s}.{f} is {got.dtype}")
            got = got.cpu().numpy()
            if not np.isfinite(got).all():
                raise AssertionError(f"golden {s}.{f} is not finite")
            mae = float(np.abs(got - pack[f"out.{s}.{f}"]).mean())
            if mae > worst:
                worst, worst_key = mae, f"{s}.{f}"
    delta = {k: after[k] - before[k] for k in after}
    _, V, _, H, W = pack["image"].shape
    log(f"[golden] exported/{UNIT.name} {W}x{H} V={V} {dn}: worst MAE "
        f"{worst:.3e} "
        f"({worst_key}), bar {tol}, first call {secs:.3f} s, launches "
        f"{delta}")
    if not worst < tol:
        raise AssertionError(f"{dn} golden MAE {worst:.3e} >= {tol}")
    require_launched(f"{dn} golden", delta, ("edge_kth", "bilinear_sample"))
    require_not_launched(f"{dn} golden", delta,
                         ("bilinear_index", "corner_blend"))
    return worst


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


def phase_slice(runner, pack, dev, profile: Path = None) -> dict:
    import torch

    from tandem_tpu_torch.mapping.tsdf import TsdfConfig
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    dn = str(runner.dtype).split(".")[-1]
    cfg = TsdfConfig()
    K = pack["K3"][0]
    H, W = runner.height, runner.width
    bgrs, poses, ref_pose = golden_window(pack)
    dmin, dmax = float(pack["depth_min"][0]), float(pack["depth_max"][0])
    backend = TandemBackend(runner, cfg, K, H, W, mesh_extraction_freq=0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    call_ms = []
    for _ in range(N_KEYFRAMES):
        t0 = time.perf_counter()
        backend.call(bgrs, poses, dmin, dmax, ref_pose)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[slice {dn}] {N_KEYFRAMES} backend calls: launches {counts}, "
        f"n_allocated {backend.stats()['n_allocated']}, peak memory "
        f"{peak_gb:.3f} GB, call ms {[round(x, 3) for x in call_ms]}")
    require_launched(f"{dn} slice", counts, ("edge_kth",), N_KEYFRAMES)
    require_launched(f"{dn} slice", counts, ("bilinear_sample",),
                     N_KEYFRAMES)
    require_not_launched(f"{dn} slice", counts,
                         ("bilinear_index", "corner_blend"))

    rdepth = backend.get_tracking_depth_map()["depth"]
    mvs = runner.get_result(device=True)["depth"]
    if mvs.dtype != torch.float32:
        raise AssertionError(f"MVSNet depth handed to fusion is {mvs.dtype}")
    rd, md = rdepth.cpu().numpy(), mvs.cpu().numpy()
    if rd.shape != (H, W) or not np.isfinite(rd).all() or (rd < 0).any():
        raise AssertionError("rendered depth not finite / non-negative")
    want = (md >= cfg.min_depth) & (md <= cfg.max_depth)
    hit = float((rd[want] > 0).mean())
    both = want & (rd > 0)
    med = float(np.median(np.abs(rd[both] - md[both])))
    log(f"[slice {dn}] render vs MVSNet depth: hit share {hit:.4f}, median "
        f"|err| {med * 100:.3f} cm over {int(both.sum())} px")
    if not (hit > 0.8 and med < 2 * cfg.voxel_size):
        raise AssertionError("rendered depth disagrees with MVSNet depth")

    # Per-keyframe parts, each ended by a device sync.
    from tandem_tpu_torch.mapping.tsdf import (allocate_blocks, integrate,
                                               render_depth_splat)
    Kt = torch.from_numpy(K).to(dev)
    pose = torch.from_numpy(ref_pose).to(dev)
    rgb = torch.from_numpy(np.ascontiguousarray(
        bgrs[-2][..., ::-1], dtype=np.float32)).to(dev)

    def mvsnet():
        runner.call_async(bgrs, poses, K, dmin, dmax)
        return runner.get_result(device=True)["depth"]

    def fuse(depth):
        allocate_blocks(backend.cfg, backend.volume, depth, Kt, pose)
        integrate(backend.cfg, backend.volume, depth, rgb, Kt, pose)
        render_depth_splat(backend.cfg, backend.volume, Kt, pose, H, W)

    pack_ms, mvs_ms, fuse_ms = [], [], []
    for _ in range(5):
        t0 = time.perf_counter()
        runner.pack_inputs(bgrs, poses, K)
        t1 = time.perf_counter()
        depth = mvsnet()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fuse(depth)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pack_ms.append((t1 - t0) * 1e3)
        mvs_ms.append((t2 - t1) * 1e3)
        fuse_ms.append((t3 - t2) * 1e3)
    if profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile as prof
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            fuse(mvsnet())
            torch.cuda.synchronize()
        events = p.key_averages()
        log(events.table(sort_by="cuda_time_total", row_limit=30))
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        log(f"[slice {dn}] profiled keyframe: {sum(e.count for e in device)}"
            f" device events (kernels and copies), device busy "
            f"{sum(e.self_device_time_total for e in device) / 1e3:.3f} ms")
        profile.mkdir(parents=True, exist_ok=True)
        p.export_chrome_trace(str(profile / f"keyframe_trace_{dn}.json"))
    m, f = float(np.median(mvs_ms)), float(np.median(fuse_ms))
    log(f"[slice {dn}] per keyframe (host clock, synced, median of 5): "
        f"MVSNet {m:.3f} ms (of which host input packing alone "
        f"{float(np.median(pack_ms)):.3f} ms), fusion "
        f"(allocate+integrate+render) {f:.3f} ms, total {m + f:.3f} ms = "
        f"{1000.0 / (m + f):.3f} KF/s (reference GPU bar 201 ms/KF for the "
        f"MVSNet alone)")
    return counts, backend


def phase_wall(dev):
    """tests/test_tsdf.py::test_render_depth_splat_wall at 640x480 with the
    default TSDF configuration."""
    import torch

    from tandem_tpu_torch.mapping.tsdf import (TsdfConfig, allocate_blocks,
                                               create_volume, integrate,
                                               render_depth_splat)
    H, W = 480, 640
    cfg = TsdfConfig()
    K = torch.tensor([[499.2, 0, 319.5], [0, 499.2, 239.5], [0, 0, 1]],
                     device=dev)
    pose = torch.eye(4, device=dev)
    depth = torch.full((H, W), 2.0, device=dev)
    color = torch.full((H, W, 3), 100.0, device=dev)
    vol = allocate_blocks(cfg, create_volume(cfg, dev), depth, K, pose)
    for _ in range(3):
        integrate(cfg, vol, depth, color, K, pose)
    r = render_depth_splat(cfg, vol, K, pose, H, W).cpu().numpy()
    crop = r[64:-64, 64:-64]
    hit = crop > 0
    med = float(np.median(np.abs(crop[hit] - 2.0)))
    pose2 = torch.tensor([[1, 0, 0, 0.15], [0, 1, 0, 0.0], [0, 0, 1, -0.3],
                          [0, 0, 0, 1]], dtype=torch.float32, device=dev)
    r2 = render_depth_splat(cfg, vol, K, pose2, H, W).cpu().numpy()
    c2 = r2[80:-80, 112:-112]
    hit2 = c2 > 0
    med2 = float(np.median(np.abs(c2[hit2] - 2.3)))
    log(f"[wall] 640x480 n_allocated {vol.n_allocated}: hit {hit.mean():.4f} "
        f"median err {med * 100:.3f} cm; shifted pose hit "
        f"{hit2.mean():.4f} median err {med2 * 100:.3f} cm")
    if not (hit.mean() > 0.97 and med < 1.5 * cfg.voxel_size
            and hit2.mean() > 0.9 and med2 < 2 * cfg.voxel_size):
        raise AssertionError("TSDF wall contract failed at 640x480")


# --- the tracker ------------------------------------------------------------

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


def _track_shapes():
    """(N, H, W, max_iter) of the tracker's levels: the 640x480 level-0
    cap, then the six 256x192 levels (the level caps of a dense
    reference, the LM iteration caps of coarse_tracker.MAX_ITERS)."""
    from tandem_tpu_torch.tracking.coarse_tracker import MAX_ITERS, _level_caps
    shapes = [(_level_caps(480, 640, True)[0], 480, 640, MAX_ITERS[0])]
    shapes += [(cap, 192 >> lvl, 256 >> lvl, MAX_ITERS[lvl])
               for lvl, cap in enumerate(_level_caps(192, 256, True))]
    return shapes


def _track_bound(T, aff, pts, planes, outs, evaluations: int) -> dict:
    """Bound of ``evaluations`` K6 evaluations of one level: the points,
    planes and poses read once and ``outs`` written once, against
    TRACK_OPS per valid point and candidate for each evaluation."""
    ops = evaluations * TRACK_OPS * int(pts[4].sum()) * T.shape[0]
    return _bound(_nbytes(T, aff, *pts, *planes, *outs), ops)


def phase_track_kernels(dev, out: dict):
    """K6 against the float64 plain version at the tracker's level caps."""
    import torch

    from tandem_tpu_torch.ops.track_reduce import (track_reduce,
                                                   track_reduce_plain)
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    shapes = [shape[:3] for shape in _track_shapes()]
    worst, times = 0.0, {}
    for i, (N, H, W) in enumerate(shapes):
        for B in (1, 5, 15):
            T, aff, pts, planes, K = _track_case(dev, N, B, H, W, 10 * i + B)
            got = track_reduce(T, aff, pts, planes, K)
            f32 = track_reduce_plain(T, aff, pts, planes, K)
            f64 = track_reduce_plain(*_double(T, aff, pts, planes, K))
            torch.cuda.synchronize()
            if not torch.equal(got[1], f32[1]):
                raise AssertionError(f"K6 num {got[1].tolist()} != plain "
                                     f"{f32[1].tolist()} at N={N} B={B}")

            def errs(x):   # (worst relative, worst absolute) over outputs
                d = [((a.double() - b).abs().max(), b.abs().max())
                     for j, (a, b) in enumerate(zip(x, f64)) if j != 1]
                return (max(float(e / m.clamp_min(1e-30)) for e, m in d),
                        max(float(e) for e, _ in d))
            (err, abs_err), (err32, _) = errs(got), errs(f32)
            worst = max(worst, abs_err)
            if not err <= TRACK_TOL:
                raise AssertionError(f"K6 at N={N} {H}x{W} B={B}: rel err "
                                     f"{err:.3e} > {TRACK_TOL}")
            ms = cuda_ms(lambda: track_reduce(T, aff, pts, planes, K))
            plain_ms = cuda_ms(lambda: track_reduce_plain(T, aff, pts,
                                                          planes, K))
            times[(N, B)] = (ms, plain_ms, _track_bound(
                T, aff, pts, planes, got, 1))
            log(f"[track kernels] N={N} level {W}x{H} B={B}: num "
                f"{int(got[1].sum())} equal; rel err vs f64 kernel "
                f"{err:.3e} (abs {abs_err:.4g}), plain f32 {err32:.3e} (tol "
                f"{TRACK_TOL}); "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    ms, plain_ms, bound = times[(shapes[0][0], 15)]
    log(f"[track kernels] N={shapes[0][0]} B=15: bound {bound}")
    out["track_reduce"] = {"max_abs_err": worst, "ms": ms,
                           "plain_ms": plain_ms, **bound, "library_ms": None}


def _cast(x, dtype):
    import torch
    return x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x


def _lm_compare(where, prev, got, pts, planes, K, max_iter, dtype) -> dict:
    """Hold one kernel step (the state ``prev`` to ``got``) against
    lm_step_plain from ``prev`` evaluated in ``dtype`` (float64 for phase
    (a); float32 along a whole level). An inactive step must leave the
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
                "dx": 0.0, "T_new": 0.0, "sums": 0.0, "ties": 0}
    p = tl.LMState(*(_cast(x, dtype) for x in prev))
    ptsd = tuple(_cast(x, dtype) for x in pts)
    planesd = tuple(_cast(x, dtype) for x in planes)
    ref = tl.lm_step_plain(p, ptsd, planesd, K, max_iter)
    e_new, n_new, _, _ = track_reduce_plain(p.T_new, p.aff_new, ptsd,
                                            planesd, K)
    e_old_n = p.e / p.n.clamp(min=1.0)
    e_new_n = e_new / n_new.clamp(min=1.0)
    margin = LM_TIE * e_old_n.clamp(min=1e-6)
    tie = ~p.done & (((e_new_n - e_old_n).abs() <= margin)
                     | ((e_old_n - e_new_n - 1e-4 * e_old_n.clamp(min=1e-6))
                        .abs() <= margin))
    ok = ~tie
    if (got.it, got.active) != (ref.it, ref.active):
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
            "dx": 0.0, "T_new": 0.0,
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
    if not (errs["solve"] <= LM_SOLVE_TOL
            and errs["se3"] <= max(LM_SE3_TOL, 4 * errs["se3_plain"])
            and max(errs["dx"], errs["T_new"]) <= LM_DX_TOL
            and errs["sums"] <= TRACK_TOL):
        raise AssertionError(f"{where}: {errs} past LM_SOLVE_TOL "
                             f"{LM_SOLVE_TOL}, LM_SE3_TOL {LM_SE3_TOL}, "
                             f"LM_DX_TOL {LM_DX_TOL}, TRACK_TOL {TRACK_TOL}")
    return errs


def _lm_one_step(dev, N, B, H, W, max_iter, seed) -> dict:
    """Phase track lm (a): a plain f32 state after one step, then one
    kernel step from it against lm_step_plain in float64."""
    import torch

    from tandem_tpu_torch.ops import track_lm as tl
    T, aff, pts, planes, K = _track_case(dev, N, B, H, W, seed)
    s = tl.lm_init_plain(T, aff, pts, planes, K, max_iter)
    s = tl.lm_step_plain(s, pts, planes, K, max_iter)
    # The points the step evaluates, without f32/f64 ties at T_new.
    pts = _drop_ties(s.T_new, s.aff_new, pts, planes, K)[2]
    buf = tl.pack_state(s)
    tl.lm_steps(buf, T, aff, pts, planes, K, max_iter, 1)
    return _lm_compare(f"track lm (a) N={N} {W}x{H} B={B}", s,
                       tl.unpack_state(buf, B), pts, planes, K, max_iter,
                       torch.float64)


def _lm_level_steps(dev, case, max_iter, where) -> dict:
    """Phase track lm (b), along the kernel's own path: the init launch
    against lm_init_plain, then every one of the max_iter step launches
    against lm_step_plain (f32, on the card) from the kernel's state before
    it; lm_level (host reads every CHECK_EVERY steps) must end in the same
    state bit for bit. Returns the worst errors and lm_level's result."""
    import torch

    from tandem_tpu_torch.ops import track_lm as tl
    T, aff, pts, planes, K = case
    B = T.shape[0]
    state = tl.new_state(B, dev)
    tl.lm_steps(state, *case, max_iter, 0, init=True)
    prev = tl.unpack_state(state, B)
    ref = tl.lm_init_plain(*case, max_iter)
    if not (torch.equal(prev.T, T) and torch.equal(prev.n, ref.n)
            and torch.equal(prev.lam, ref.lam) and prev.it == ref.it
            and prev.active == ref.active):
        raise AssertionError(f"{where}: the init launch differs from "
                             "lm_init_plain")
    worst = {"solve": 0.0, "se3": 0.0, "se3_plain": 0.0, "dx": 0.0,
             "T_new": 0.0, "sums": 0.0, "ties": 0}
    for _ in range(max_iter):
        tl.lm_steps(state, *case, max_iter, 1)
        got = tl.unpack_state(state, B)
        errs = _lm_compare(where, prev, got, pts, planes, K, max_iter,
                           torch.float32)
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
        prev = got
    out = tl.lm_level(*case, max_iter)
    enough = tl.state_views(state, B)["n0"] >= tl.MIN_TERMS
    if not (torch.equal(out[0], tl._bwhere(enough, prev.T, T))
            and torch.equal(out[2], prev.e) and int(out[4]) == prev.it):
        raise AssertionError(f"{where}: lm_level differs from its steps")
    return worst, out


def phase_track_lm(dev, out: dict):
    """The LM kernel against its plain version: one step against float64,
    whole levels step by step and against the plain f32 level on the
    card."""
    import torch

    from tandem_tpu_torch.ops import track_lm as tl
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    worst = {"solve": 0.0, "se3": 0.0, "se3_plain": 0.0, "dx": 0.0,
             "T_new": 0.0, "sums": 0.0}
    shapes = _track_shapes()
    for i, (N, H, W, _) in enumerate(shapes):
        for B in (1, 5, 15):
            errs = _lm_one_step(dev, N, B, H, W, 50, 100 + 10 * i + B)
            worst = {k: max(v, errs[k]) for k, v in worst.items()}
            log(f"[track lm] (a) N={N} level {W}x{H} B={B}: one step vs "
                f"float64: dx's backward error {errs['solve']:.3e} "
                f"(tol {LM_SOLVE_TOL}), T_new vs se3_exp(dx) T "
                f"{errs['se3']:.3e} (plain f32 {errs['se3_plain']:.3e}, tol "
                f"{LM_SE3_TOL} or 4x plain); dx {errs['dx']:.3e} "
                f"and T_new {errs['T_new']:.3e} vs the step (tol "
                f"{LM_DX_TOL}); e/H/g {errs['sums']:.3e} (tol {TRACK_TOL}); "
                f"ties {errs['ties']}; active {errs['active']}; it, active, "
                f"accept, done, lam equal")
    res = {}
    for i, (N, H, W, max_iter) in enumerate(shapes):
        for B in (1, 5, 15):
            case = _track_case(dev, N, B, H, W, 10 * i + B)
            where = f"track lm (b) N={N} {W}x{H} B={B}"
            steps, got = _lm_level_steps(dev, case, max_iter, where)
            worst = {k: max(v, steps[k]) for k, v in worst.items()}
            ref = tl.lm_level_plain(*case, max_iter)
            d_T = float((got[0] - ref[0]).abs().max())
            d_aff = float((got[1] - ref[1]).abs().max())
            its = (int(got[4]), int(ref[4]))
            tol_T = LM_POSE_PX / case[4][0]
            close = d_T <= tol_T and d_aff <= LM_AFF_TOL
            # Paths that took another number of steps parted at a near-tie
            # (the step check above holds each step); elsewhere, and always
            # at the 640x480 cap, the end points must agree.
            if not torch.isfinite(got[0]).all() or not (
                    close or (i > 0 and its[0] != its[1])):
                raise AssertionError(f"{where}: T {d_T:.3e} aff {d_aff:.3e} "
                                     f"past {tol_T:.3e} / {LM_AFF_TOL}")
            ms = cuda_ms(lambda: tl.lm_level(*case, max_iter))
            plain_ms = cuda_ms(lambda: tl.lm_level_plain(*case, max_iter),
                               iters=5, warmup=1)
            res[(N, B)] = (ms, plain_ms, its, d_T, _track_bound(
                *case[:4], got[:4], its[0] + 1))
            log(f"[track lm] (b) N={N} level {W}x{H} B={B} max_iter "
                f"{max_iter}: every step vs the plain step from the same "
                f"state: dx's backward error {steps['solve']:.3e}, T_new vs "
                f"se3_exp(dx) T {steps['se3']:.3e} (plain f32 "
                f"{steps['se3_plain']:.3e}), dx {steps['dx']:.3e} and "
                f"T_new {steps['T_new']:.3e} vs the step, e/H/g "
                f"{steps['sums']:.3e}, ties {steps['ties']}; lm_level equal "
                f"to its steps; end point vs lm_level_plain: pose {d_T:.3e} "
                f"(tol {tol_T:.3e}), aff {d_aff:.3e} (tol {LM_AFF_TOL})"
                f"{'' if close else ', paths parted'}; iterations kernel "
                f"{its[0]} plain {its[1]}; level kernel {ms:.4f} ms plain "
                f"{plain_ms:.4f} ms")
    # How often the host reads the active flag: each level's time for each
    # CHECK_EVERY (0: never, all max_iter steps launched).
    for i in (0, 4):
        N, H, W, max_iter = shapes[i]
        for B in (1, 15):
            case = _track_case(dev, N, B, H, W, 10 * i + B)
            sweep = {k: cuda_ms(lambda: tl.lm_level(*case, max_iter,
                                                    check_every=k))
                     for k in (1, 2, 4, 8, 16, 0)}
            log(f"[track lm] check_every sweep N={N} {W}x{H} B={B} "
                f"max_iter {max_iter} (iterations {res[(N, B)][2][0]}): "
                + ", ".join(f"k={k} {v:.4f} ms" for k, v in sweep.items()))
    ms, plain_ms, its, d_T, bound = res[(shapes[0][0], 15)]
    log(f"[track lm] N={shapes[0][0]} B=15: bound {bound} for "
        f"{its[0] + 1} evaluations; worst over (a) and (b) {worst}")
    out["track_lm"] = {"max_abs_err": max(worst["se3"], d_T), "ms": ms,
                       "plain_ms": plain_ms, **bound, "library_ms": None}


def _motion_init(ref_c2w, last_c2w, prev_c2w):
    """FullSystem._motion_model: constant velocity, as T_ref->new."""
    pred = last_c2w @ np.linalg.inv(prev_c2w) @ last_c2w
    return (np.linalg.inv(pred) @ ref_c2w).astype(np.float32)


def _track_loop(dev, scene, ref, ref_id: int, frames, tag: str):
    """Track ``frames`` one after another from the constant-motion
    prediction; print and return each frame's (position error m, worst
    rotation entry error) against the GT poses."""
    import torch

    from tandem_tpu_torch.tracking.coarse_tracker import track_frame
    ref_c2w = scene.c2w(ref_id).astype(np.float64)
    prev, last = scene.c2w(ref_id - 1).astype(np.float64), ref_c2w
    aff0 = torch.tensor([1.0, 0.0], device=dev)
    errs, ms, iters = [], [], []
    for f in frames:
        img = torch.from_numpy(scene.gray(f)).to(dev)
        T0 = torch.from_numpy(_motion_init(ref_c2w, last, prev)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = track_frame(ref, img, T0, aff0)
        T = out["T"].cpu().numpy().astype(np.float64)
        ms.append((time.perf_counter() - t0) * 1e3)
        iters.append(sum(out["lm_iters"]))
        c2w = ref_c2w @ np.linalg.inv(T)
        gt = scene.c2w(f).astype(np.float64)
        errs.append((float(np.linalg.norm(c2w[:3, 3] - gt[:3, 3])),
                     float(np.abs(c2w[:3, :3] - gt[:3, :3]).max())))
        if not np.isfinite(T).all() or not np.isfinite(float(
                out["energy"])):
            raise AssertionError(f"{tag}: frame {f} pose not finite")
        prev, last = last, c2w
    log(f"[{tag}] frames {frames[0]}-{frames[-1]} on ref {ref_id}: position "
        f"error mm {[round(e * 1e3, 3) for e, _ in errs]}, rotation entry "
        f"error {[round(r, 5) for _, r in errs]}, LM iterations {iters}, "
        f"ms/frame {[round(x, 3) for x in ms]} (host clock, synced)")
    return errs


def _dense_ref(dev, depth, c2w, gray, K, fx, fy, cx, cy):
    import torch

    from tandem_tpu_torch.tracking.coarse_tracker import (make_tracker_ref,
                                                          splat_depth_to_ref)
    H, W = gray.shape
    idp, w = splat_depth_to_ref(depth, c2w, c2w, K, H, W, stride=3)
    return make_tracker_ref(torch.from_numpy(gray).to(dev), fx, fy, cx, cy,
                            dense_idepth=idp, dense_weight=w)


def phase_track_gt(dev) -> dict:
    """Track against a model fused from the fixture's GT depths."""
    import torch

    from tandem_tpu_torch.data.replica import ReplicaScene
    from tandem_tpu_torch.mapping.tsdf import (TsdfConfig, allocate_blocks,
                                               create_volume, integrate,
                                               render_depth_splat,
                                               surface_axis_slots)
    scene = ReplicaScene(FIXTURE)
    cfg = TsdfConfig()
    K = torch.from_numpy(scene.K).to(dev)
    vol = create_volume(cfg, dev)
    for i in range(7):
        d = torch.from_numpy(scene.depth(i)).to(dev)
        p = torch.from_numpy(scene.c2w(i)).to(dev)
        rgb = torch.from_numpy(np.ascontiguousarray(
            scene.bgr(i)[..., ::-1], dtype=np.float32)).to(dev)
        allocate_blocks(cfg, vol, d, K, p)
        integrate(cfg, vol, d, rgb, K, p)
    pose = torch.from_numpy(scene.c2w(6)).to(dev)
    slots, counts = surface_axis_slots(cfg, vol, K, pose, scene.height,
                                       scene.width)
    rdepth = render_depth_splat(cfg, vol, K, pose, scene.height, scene.width,
                                axis_slots=slots, axis_counts=counts.tolist())
    gt = torch.from_numpy(scene.depth(6)).to(dev)
    hit = rdepth > 0
    med = float((rdepth[hit] - gt[hit]).abs().median())
    log(f"[track gt] map from GT depths 0-6: n_allocated {vol.n_allocated}, "
        f"render at frame 6 hit {float(hit.float().mean()):.4f}, median "
        f"|err| {med * 1e3:.3f} mm")
    reset_counts()
    ref = _dense_ref(dev, rdepth, pose, scene.gray(6), K, scene.fx,
                     scene.fy, scene.cx, scene.cy)
    errs = _track_loop(dev, scene, ref, 6, list(range(7, 15)), "track gt")
    counts = read_counts()
    require_launched("track gt", counts, ("track_reduce", "track_lm"))
    worst = max(e for e, _ in errs)
    log(f"[track gt] worst position error {worst * 1e3:.3f} mm (bound "
        f"{GT_TRACK_BOUND * 1e3} mm), launches {counts}")
    if not worst < GT_TRACK_BOUND:
        raise AssertionError(f"track gt: {worst * 1e3:.3f} mm >= bound")
    return counts


def phase_track_mvs(dev) -> dict:
    """Track against the model the backend fuses from trained-MVSNet depth
    (the fixture's first two 7-view windows, f32)."""
    import torch

    from tandem_tpu_torch.data.replica import ReplicaScene
    from tandem_tpu_torch.mapping.tsdf import TsdfConfig
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
    scene = ReplicaScene(FIXTURE)
    with open(UNIT / "model_config.json") as f:
        cfg = json.load(f)
    runner = MvsnetRunner(CvaMVSNet(**cfg, dtype=torch.float32),
                          load_variables(UNIT / "model_variables.pkl"),
                          scene.height, scene.width, view_num=7, device=dev)
    backend = TandemBackend(runner, TsdfConfig(), scene.K, scene.height,
                            scene.width)
    calls = []
    for window in scene.windows[:2]:
        depths = [scene.depth(i) for i in window]
        valid = np.concatenate([d[d > 0] for d in depths])
        calls.append(([scene.bgr(i) for i in window],
                      [scene.c2w(i) for i in window], float(valid.min()),
                      float(valid.max()), scene.c2w(window[-1])))
    ref_id = scene.windows[1][-1]
    torch.cuda.synchronize()
    reset_counts()
    for args in calls:
        backend.call(*args)
    dm = backend.get_tracking_depth_map()
    K = torch.from_numpy(scene.K).to(dev)
    c2w = torch.from_numpy(np.asarray(dm["c2w"], np.float32)).to(dev)
    ref = _dense_ref(dev, dm["depth"], c2w, scene.gray(ref_id), K, scene.fx,
                     scene.fy, scene.cx, scene.cy)
    errs = _track_loop(dev, scene, ref, ref_id,
                       list(range(ref_id + 1, ref_id + 9)), "track mvs")
    counts = read_counts()
    require_launched("track mvs", counts,
                     ("edge_kth", "bilinear_sample", "track_reduce",
                      "track_lm"))
    require_not_launched("track mvs", counts,
                         ("bilinear_index", "corner_blend"))
    worst = max(e for e, _ in errs)
    log(f"[track mvs] backend {backend.last_fuse}; worst position error "
        f"{worst * 1e3:.3f} mm (bound {MVS_TRACK_BOUND * 1e3} mm), "
        f"launches {counts}")
    if not worst <= MVS_TRACK_BOUND:
        raise AssertionError(f"track mvs: {worst * 1e3:.3f} mm > bound")
    return counts


def _gray(bgr):
    from tandem_tpu_torch.data.replica import gray
    return gray(bgr).astype(np.float32)


def _median_ms(fn, reps: int = 5):
    import torch
    out, ms = None, []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), out


def _profile_track(ref, img, T0, aff0, profile: Path):
    """torch.profiler over one track_frame: the kernel table, the device's
    busy share of the host span, and a trace in ``profile``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    from tandem_tpu_torch.ops.track_lm import lm_level
    from tandem_tpu_torch.tracking.coarse_tracker import track_frame
    torch.cuda.synchronize()
    pairs = lm_level.launches
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        out = track_frame(ref, img, T0, aff0)
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    pairs = lm_level.launches - pairs
    events = p.key_averages()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    log(events.table(sort_by="self_cuda_time_total", row_limit=20))
    log(f"[track 640x480] profiled track_frame: device busy {busy_ms:.3f} "
        f"ms of a {span_ms:.3f} ms host span (profiler on), idle "
        f"{100 * (1 - busy_ms / span_ms):.1f}%; launches per frame: "
        f"{sum(e.count for e in device)} device events (kernels and "
        f"copies), of them {2 * pairs} track_lm launches ({pairs} pairs: "
        f"6 init + {pairs - 6} steps, {sum(out['lm_iters'])} of them "
        f"active; LM iterations by level {out['lm_iters']})")
    profile.mkdir(parents=True, exist_ok=True)
    p.export_chrome_trace(str(profile / "track_frame_trace.json"))


def phase_track_640(dev, backend, pack, profile: Path = None) -> dict:
    """Tracker times at the deployed size: the dense reference on golden
    view 0 from the f32 slice's rendered depth (rendered at view 0's pose);
    views 1-6 tracked from the identity. The golden views are not
    photometrically consistent with their poses, so no accuracy bound."""
    import torch

    from tandem_tpu_torch.core.se3 import se3_exp
    from tandem_tpu_torch.tracking.coarse_tracker import (
        make_tracker_ref, rotation_perturbations, splat_depth_to_ref,
        track_frame, track_frame_multi)
    rgb = pack["image"][0]                            # (V, 3, H, W) RGB
    grays = [_gray(np.ascontiguousarray(v.transpose(1, 2, 0)[..., ::-1]))
             for v in rgb]
    H, W = grays[0].shape
    K = torch.from_numpy(pack["K3"][0]).to(dev)
    fx, fy, cx, cy = (float(pack["K3"][0][i]) for i in ((0, 0), (1, 1),
                                                         (0, 2), (1, 2)))
    dm = backend.get_tracking_depth_map()
    c2w = torch.from_numpy(np.asarray(dm["c2w"], np.float32)).to(dev)
    img0 = torch.from_numpy(grays[0]).to(dev)
    reset_counts()
    splat_ms, (idp, w) = _median_ms(
        lambda: splat_depth_to_ref(dm["depth"], c2w, c2w, K, H, W, stride=3))
    ref_ms, ref = _median_ms(lambda: make_tracker_ref(
        img0, fx, fy, cx, cy, dense_idepth=idp, dense_weight=w))
    log(f"[track 640x480] per keyframe: splat_depth_to_ref {splat_ms:.3f} "
        f"ms, make_tracker_ref {ref_ms:.3f} ms (host clock, synced, median "
        f"of 5); points per level {[int(v.sum()) for v in ref.pvalid]} of "
        f"caps {[v.numel() for v in ref.pvalid]}")
    eye = torch.eye(4, device=dev)
    aff0 = torch.tensor([1.0, 0.0], device=dev)
    moves = torch.tensor([[0.01, 0, 0, 0, 0, 0], [-0.01, 0, 0, 0, 0, 0],
                          [0, 0.01, 0, 0, 0, 0], [0, 0, 0, 0, 0.005, 0]],
                         device=dev)
    cand5 = torch.cat([eye[None], se3_exp(moves)]).contiguous()
    cand15 = torch.from_numpy(rotation_perturbations()).to(dev)
    rows = {"track_frame": [], "multi 5": [], "multi 15": []}
    iters = {k: [] for k in rows}
    for v in range(1, len(grays)):
        img = torch.from_numpy(grays[v]).to(dev)
        for name, fn in (
                ("track_frame", lambda: track_frame(ref, img, eye, aff0)),
                ("multi 5", lambda: track_frame_multi(ref, img, cand5,
                                                      aff0)),
                ("multi 15", lambda: track_frame_multi(ref, img, cand15,
                                                       aff0))):
            ms, out = _median_ms(fn, reps=3)
            if not torch.isfinite(out["T"]).all():
                raise AssertionError(f"track 640x480 {name}: view {v} pose "
                                     "not finite")
            rows[name].append(ms)
            iters[name].append(sum(out["lm_iters"]))
    counts = read_counts()
    require_launched("track 640x480", counts, ("track_reduce", "track_lm"))
    if profile:
        _profile_track(ref, torch.from_numpy(grays[1]).to(dev), eye, aff0,
                       profile)
    for name in rows:
        log(f"[track 640x480] {name}: ms/frame {[round(x, 3) for x in rows[name]]}"
            f" median {float(np.median(rows[name])):.3f} ms (host clock, "
            f"synced, median of 3 per view); LM iterations {iters[name]}")
    log(f"[track 640x480] launches {counts}")
    return counts


def _copy_volume(vol):
    import dataclasses
    return dataclasses.replace(vol, **{f: getattr(vol, f).clone() for f in (
        "page_table", "block_coords", "tsdf", "weight", "color")})


def _turned(pose: np.ndarray, deg: float) -> np.ndarray:
    a = np.deg2rad(deg)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    out = pose.copy()
    out[:3, :3] = pose[:3, :3] @ R
    return out


def _culled_cases(dev, name, cfg, vol, depth, rgb, K, pose: np.ndarray):
    """At the pose and turned by 20/40/60 degrees: integrate_culled equals
    integrate, and both culled renders equal the full walk (torch.equal)."""
    import torch

    from tandem_tpu_torch.mapping.tsdf import (integrate, integrate_culled,
                                               render_depth_splat,
                                               surface_axis_slots,
                                               visible_slots)
    H, W = depth.shape
    for deg in (0.0, 20.0, 40.0, 60.0):
        p = torch.from_numpy(_turned(pose, deg)).to(dev)
        vis_ms, (slots, n_vis) = _median_ms(
            lambda: visible_slots(cfg, vol, K, p, H, W), reps=3)
        n_vis = int(n_vis)
        full = integrate(cfg, _copy_volume(vol), depth, rgb, K, p)
        cull = integrate_culled(cfg, _copy_volume(vol), depth, rgb, K, p,
                                slots, n_vis)
        for f in ("tsdf", "weight", "color"):
            if not torch.equal(getattr(full, f), getattr(cull, f)):
                raise AssertionError(f"culled {name} {deg} deg: "
                                     f"integrate_culled {f} != full walk")
        # Timed on the two copies, in place: the same work every repeat.
        full_ms, _ = _median_ms(lambda: integrate(cfg, full, depth, rgb, K,
                                                  p), reps=3)
        cull_ms, _ = _median_ms(lambda: integrate_culled(
            cfg, cull, depth, rgb, K, p, slots, n_vis), reps=3)
        del full, cull
        ax_ms, (ax_slots, ax_counts) = _median_ms(
            lambda: surface_axis_slots(cfg, vol, K, p, H, W), reps=3)
        ax_counts = ax_counts.tolist()
        r_full_ms, r_full = _median_ms(
            lambda: render_depth_splat(cfg, vol, K, p, H, W), reps=3)
        r_vis_ms, r_vis = _median_ms(lambda: render_depth_splat(
            cfg, vol, K, p, H, W, slots=slots, n_visible=n_vis), reps=3)
        r_ax_ms, r_ax = _median_ms(lambda: render_depth_splat(
            cfg, vol, K, p, H, W, axis_slots=ax_slots,
            axis_counts=ax_counts), reps=3)
        if not (torch.equal(r_full, r_vis) and torch.equal(r_full, r_ax)):
            raise AssertionError(f"culled {name} {deg} deg: culled render "
                                 "!= full walk")
        log(f"[culled] {name} turned {deg:.0f} deg: n_allocated "
            f"{vol.n_allocated} n_visible {n_vis} axis counts {ax_counts}; "
            f"equal; integrate full {full_ms:.3f} ms culled {cull_ms:.3f} "
            f"ms (+ visible_slots {vis_ms:.3f} ms); render full "
            f"{r_full_ms:.3f} ms "
            f"frustum-culled "
            f"{r_vis_ms:.3f} ms axis-culled {r_ax_ms:.3f} ms (+ "
            f"surface_axis_slots {ax_ms:.3f} ms) (host clock, synced, "
            f"median of 3)")


def phase_culled(dev, backend, pack):
    """Culled == full on the f32 slice's map and on the 640x480 wall."""
    import torch

    from tandem_tpu_torch.mapping.tsdf import (TsdfConfig, allocate_blocks,
                                               create_volume, integrate)
    K = torch.from_numpy(pack["K3"][0]).to(dev)
    bgrs, poses, ref_pose = golden_window(pack)
    backend.runner.call_async(bgrs, poses, pack["K3"][0],
                              float(pack["depth_min"][0]),
                              float(pack["depth_max"][0]))
    depth = backend.runner.get_result(device=True)["depth"]
    rgb = torch.from_numpy(np.ascontiguousarray(
        bgrs[-2][..., ::-1], dtype=np.float32)).to(dev)
    _culled_cases(dev, "golden map", backend.cfg, backend.volume, depth, rgb,
                  K, np.asarray(ref_pose, np.float32))
    H, W = 480, 640
    cfg = TsdfConfig()
    Kw = torch.tensor([[499.2, 0, 319.5], [0, 499.2, 239.5], [0, 0, 1]],
                      device=dev)
    pose = torch.eye(4, device=dev)
    wall = torch.full((H, W), 2.0, device=dev)
    color = torch.full((H, W, 3), 100.0, device=dev)
    vol = allocate_blocks(cfg, create_volume(cfg, dev), wall, Kw, pose)
    integrate(cfg, vol, wall, color, Kw, pose)
    _culled_cases(dev, "wall", cfg, vol, wall, color, Kw,
                  np.eye(4, dtype=np.float32))


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-dir", type=Path, default=None,
                    help="also profile one keyframe per dtype and one "
                         "track_frame; write the traces here")
    profile_dir = ap.parse_args().profile_dir
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not ((REPO / "tandem_tpu_torch" / "csrc").is_dir()
            and (UNIT / "model_variables.pkl").exists()):
        print("chip_smoke: run from a checkout of the repository "
              "(tandem_tpu_torch/ and exported/tandem/ beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    kind = phase_device()
    phase_build()
    measured = phase_kernels(dev)
    phase_track_kernels(dev, measured)
    phase_track_lm(dev, measured)
    paths = {"probes": phase_probes()}
    for dtype, tol in ((torch.float32, GOLDEN_TOL),
                       (torch.bfloat16, BF16_TOL)):
        runner, pack = load_runner(dev, dtype)
        phase_golden(runner, pack, dev, tol)
        dn = str(dtype).split(".")[-1]
        paths[f"{dn}_slice"], backend = phase_slice(runner, pack, dev,
                                                    profile_dir)
        if dtype == torch.float32:
            paths["track_640x480"] = phase_track_640(dev, backend, pack,
                                                     profile_dir)
            phase_culled(dev, backend, pack)
        del runner, backend
        torch.cuda.empty_cache()
    phase_wall(dev)
    paths["track_gt"] = phase_track_gt(dev)
    paths["track_mvs"] = phase_track_mvs(dev)
    log(f"[paths] launches by path: {paths} "
        f"({time.perf_counter() - t_start:.1f} s in all)")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(c[name] for c in paths.values()),
                        **measured[name]})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
