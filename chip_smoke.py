#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: the keyframe map path in
float32 and in bfloat16 (the JAX package's deployed dtype), and the dense
coarse tracker tracking against the TSDF model.

    python3 chip_smoke.py                    # from the root of a checkout
    python3 chip_smoke.py --profile-dir DIR  # + a torch.profiler table of
                                             #   one keyframe per dtype and
                                             #   of one track_frame at
                                             #   640x480, traces in DIR

Phases, each printing its numbers before the last line:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    compile the CUDA kernels of tandem_tpu_torch/csrc/ (one nvcc
              per source, in parallel) and print ptxas's register report;
  3. kernels  each hand kernel against its plain PyTorch version on the
              card, exact (torch.equal), with both times: K1 edge_kth;
              P5 bilinear_index and P3 corner_blend in f32 and bf16 at
              the three stage shapes of abl04 640x480; row_gather;
  4. track kernels  K6 track_reduce against a float64 evaluation of its
              plain version at the tracker's level caps (640x480 level 0,
              the six 256x192 levels) for B = 1, 5, 15 candidates, within
              TRACK_TOL of the largest |entry|; num equal to the plain
              f32 version's; both times;
  5. probes   the torch ports of the three Pallas probe scripts at their
              own shapes (tandem_tpu_torch/experiments), M rows/s;
  6. golden   the trained abl04 unit (exported/tandem, 640x480, V=7)
              replays sample_inputs.npz in f32: worst MAE < 1e-2 over all
              12 outputs, the reference's own boot-check bar; P5, P3 and
              K1 must have launched;
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
              MVS_TRACK_BOUND; K1, P5, P3 and K6 must have launched.
The launch counters are set to 0 just before each driven path (the probes,
the slices, the three tracking paths) and read just after it. The last line
of stdout is the JSON result; any failed phase exits non-zero without it.
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
    "row_gather": ("tandem_tpu_torch/csrc/row_gather.cu",
                   "experiments/pallas_gather_probe.py:35 "
                   "experiments/pallas_gather_probe.py:59 "
                   "experiments/pallas_shuffle_probe.py:25"),
    "track_reduce": ("tandem_tpu_torch/csrc/track_reduce.cu",
                     "tandem_tpu/tracking/coarse_tracker.py:348 "
                     "(_energy_and_system: XLA code, not a Pallas kernel)"),
}


def log(msg: str):
    print(msg, flush=True)


def wrappers() -> dict:
    """Each kernel's wrapper; ``.launches`` counts its kernel launches."""
    from tandem_tpu_torch.ops.bilinear_index import bilinear_index
    from tandem_tpu_torch.ops.corner_blend import corner_blend
    from tandem_tpu_torch.ops.edge_kth import edge_kth_value
    from tandem_tpu_torch.ops.row_gather import row_gather
    from tandem_tpu_torch.ops.track_reduce import track_reduce
    return {"edge_kth": edge_kth_value, "bilinear_index": bilinear_index,
            "corner_blend": corner_blend, "row_gather": row_gather,
            "track_reduce": track_reduce}


def reset_counts():
    for fn in wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in wrappers().items()}


def require_launched(path: str, counts: dict, names, at_least: int = 1):
    for name in names:
        if counts[name] < at_least:
            raise AssertionError(f"{path}: {name} launched {counts[name]} "
                                 f"< {at_least} times")


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
    log(f"[kernels] edge_kth 1x480x640: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms (CUDA events, median)")
    out["edge_kth"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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


def _sample_kernels(dev, out: dict):
    """P5 and P3 at the abl04 640x480 stage shapes, f32 and bf16."""
    import torch

    from tandem_tpu_torch.ops.bilinear_index import (bilinear_index,
                                                     bilinear_index_plain)
    from tandem_tpu_torch.ops.corner_blend import (corner_blend,
                                                   corner_blend_plain)
    from tandem_tpu_torch.ops.grid_sample import pack_corners
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
            n = rows.numel()
            log(f"[kernels] {stage} {dn} N={n} C={C}: bilinear_index exact, "
                f"kernel {t5[0]:.4f} ms plain {t5[1]:.4f} ms; corner_blend "
                f"exact, kernel {t3[0]:.4f} ms plain {t3[1]:.4f} ms")
            for name, e, t in (("bilinear_index", e5, t5),
                               ("corner_blend", e3, t3)):
                r = res[name]
                r["max_abs_err"] = max(r["max_abs_err"], e)
                if stage == "stage1" and dtype == torch.bfloat16:
                    r["ms"], r["plain_ms"] = t
    out.update(res)


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
    log(f"[kernels] row_gather ({M}, {CW}) bf16 N={N_FULL}: exact in f32 "
        f"and bf16 (and width 33); kernel {ms:.4f} ms plain {plain_ms:.4f} "
        f"ms")
    out["row_gather"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_kernels(dev) -> dict:
    out = {}
    _edge_kth(dev, out)
    _sample_kernels(dev, out)
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
    require_launched(f"{dn} golden", delta,
                     ("edge_kth", "bilinear_index", "corner_blend"))
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
    require_launched(f"{dn} slice", counts,
                     ("bilinear_index", "corner_blend"), N_KEYFRAMES)

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
        from torch.profiler import ProfilerActivity, profile as prof
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            fuse(mvsnet())
            torch.cuda.synchronize()
        log(p.key_averages().table(sort_by="cuda_time_total", row_limit=30))
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


def phase_track_kernels(dev, out: dict):
    """K6 against the float64 plain version at the tracker's level caps."""
    import torch

    from tandem_tpu_torch.ops.track_reduce import (track_reduce,
                                                   track_reduce_plain)
    from tandem_tpu_torch.tracking.coarse_tracker import _level_caps
    from tandem_tpu_torch.utils.cuda_timing import cuda_ms
    shapes = [(_level_caps(480, 640, True)[0], 480, 640)]
    shapes += [(cap, 192 >> lvl, 256 >> lvl)
               for lvl, cap in enumerate(_level_caps(192, 256, True))]
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
            times[(N, B)] = (ms, plain_ms)
            log(f"[track kernels] N={N} level {W}x{H} B={B}: num "
                f"{int(got[1].sum())} equal; rel err vs f64 kernel "
                f"{err:.3e} (abs {abs_err:.4g}), plain f32 {err32:.3e} (tol "
                f"{TRACK_TOL}); "
                f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    ms, plain_ms = times[(shapes[0][0], 15)]
    out["track_reduce"] = {"max_abs_err": worst, "ms": ms,
                           "plain_ms": plain_ms}


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
    require_launched("track gt", counts, ("track_reduce",))
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
                     ("edge_kth", "bilinear_index", "corner_blend",
                      "track_reduce"))
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

    from tandem_tpu_torch.tracking.coarse_tracker import track_frame
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU,
                          ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        track_frame(ref, img, T0, aff0)
        torch.cuda.synchronize()
        span_ms = (time.perf_counter() - t0) * 1e3
    events = p.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    log(events.table(sort_by="self_cuda_time_total", row_limit=20))
    log(f"[track 640x480] profiled track_frame: device busy {busy_ms:.3f} "
        f"ms of a {span_ms:.3f} ms host span (profiler on), idle "
        f"{100 * (1 - busy_ms / span_ms):.1f}%")
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
    require_launched("track 640x480", counts, ("track_reduce",))
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
                        **{k: measured[name][k] for k in (
                            "max_abs_err", "ms", "plain_ms")}})
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
