#!/usr/bin/env python3
"""Drive the PyTorch port's keyframe map path once on one NVIDIA GPU, in
float32 and in bfloat16 (the JAX package's deployed dtype).

    python3 chip_smoke.py                    # from the root of a checkout
    python3 chip_smoke.py --profile-dir DIR  # + a torch.profiler table of
                                             #   one keyframe per dtype,
                                             #   traces in DIR

Phases, each printing its numbers before the last line:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    compile the CUDA kernels of tandem_tpu_torch/csrc/ (one nvcc
              per source, in parallel) and print ptxas's register report;
  3. kernels  each hand kernel against its plain PyTorch version on the
              card, exact (torch.equal), with both times: K1 edge_kth;
              P5 bilinear_index and P3 corner_blend in f32 and bf16 at
              the three stage shapes of abl04 640x480; row_gather;
  4. probes   the torch ports of the three Pallas probe scripts at their
              own shapes (tandem_tpu_torch/experiments), M rows/s;
  5. golden   the trained abl04 unit (exported/tandem, 640x480, V=7)
              replays sample_inputs.npz in f32: worst MAE < 1e-2 over all
              12 outputs, the reference's own boot-check bar; P5, P3 and
              K1 must have launched;
  6. slice    TandemBackend (MvsnetRunner + TSDF allocate, integrate,
              splat render) runs 4 keyframes built from the golden views
              in f32; the rendered depth must agree with the MVSNet depth;
              per-keyframe times;
  7. golden and slice again in bf16: worst MAE < 1e-1 (10 x the bar, the
              JAX runtime's bf16 boot check), the same render contract;
  8. wall     the TSDF wall contract at 640x480.
The launch counters are set to 0 just before each driven path (the probes,
the f32 slice, the bf16 slice) and read just after it. The last line of
stdout is the JSON result; any failed phase exits non-zero without it.
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
}


def log(msg: str):
    print(msg, flush=True)


def wrappers() -> dict:
    """Each kernel's wrapper; ``.launches`` counts its kernel launches."""
    from tandem_tpu_torch.ops.bilinear_index import bilinear_index
    from tandem_tpu_torch.ops.corner_blend import corner_blend
    from tandem_tpu_torch.ops.edge_kth import edge_kth_value
    from tandem_tpu_torch.ops.row_gather import row_gather
    return {"edge_kth": edge_kth_value, "bilinear_index": bilinear_index,
            "corner_blend": corner_blend, "row_gather": row_gather}


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
    return counts


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


def main() -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile-dir", type=Path, default=None,
                    help="also profile one keyframe per dtype; write the "
                         "traces here")
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
    paths = {"probes": phase_probes()}
    for dtype, tol in ((torch.float32, GOLDEN_TOL),
                       (torch.bfloat16, BF16_TOL)):
        runner, pack = load_runner(dev, dtype)
        phase_golden(runner, pack, dev, tol)
        dn = str(dtype).split(".")[-1]
        paths[f"{dn}_slice"] = phase_slice(runner, pack, dev, profile_dir)
        del runner
        torch.cuda.empty_cache()
    phase_wall(dev)
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
