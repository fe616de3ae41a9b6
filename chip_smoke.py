#!/usr/bin/env python3
"""Drive the PyTorch port's keyframe map path once on one NVIDIA GPU.

    python3 chip_smoke.py                    # from the root of a checkout
    python3 chip_smoke.py --profile-dir DIR  # + a torch.profiler table of
                                             #   one keyframe, trace in DIR

Phases, each printing its numbers before the last line:
  1. device   the card's name and power limit (nvidia-smi);
  2. build    compile the CUDA kernels of tandem_tpu_torch/csrc/;
  3. kernels  K1 (edge_kth) against its plain PyTorch version on the card,
              exact, with both times;
  4. golden   the trained abl04 unit (exported/tandem, 640x480, V=7) in f32
              replays sample_inputs.npz: worst MAE < 1e-2 over all 12
              outputs, the reference's own boot-check bar;
  5. slice    TandemBackend (MvsnetRunner + TSDF allocate, integrate,
              splat render) runs 4 keyframes built from the golden views;
              the rendered depth must agree with the MVSNet depth; then
              the TSDF wall contract at 640x480 and per-keyframe times.
The last line of stdout is the JSON result; any failed phase exits
non-zero without it. Without a CUDA device, or without the repository
beside this script, it fails at once. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
UNIT = REPO / "exported" / "tandem"
GOLDEN_TOL = 1e-2
N_KEYFRAMES = 4


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median per-call device time of ``fn`` over ``iters`` launches, timed
    with CUDA events (5 rounds of iters // 5 calls each)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_round = max(iters // 5, 1)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_round):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_round)
    return float(np.median(times))


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    log(smi.stdout.strip().splitlines()[0])
    return name


def phase_build():
    from tandem_tpu_torch.ops import _build
    secs = _build.build()
    log(f"[build] csrc/*.cu -> {_build.library_path().relative_to(REPO)} "
        f"in {secs:.2f} s")
    _build.kernels()


def phase_kernels(dev):
    import torch

    from tandem_tpu_torch.ops.edge_kth import edge_kth_plain, edge_kth_value
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
        out = edge_kth_value(d)
        torch.cuda.synchronize()
        ref = edge_kth_plain(d)
        e = float((out - ref).abs().max())
        if not torch.equal(out, ref):
            raise AssertionError(f"K1 differs from plain at {name}: {e}")
        err = max(err, e)
        log(f"[kernels] edge_kth {name}: exact (max_abs_err {e})")
    d = torch.from_numpy(cases["1x480x640"]).to(dev)
    ms = cuda_ms(lambda: edge_kth_value(d), iters=50)
    plain_ms = cuda_ms(lambda: edge_kth_plain(d), iters=20)
    log(f"[kernels] edge_kth 1x480x640: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms (CUDA events, median)")
    return {"name": "edge_kth", "route": "cuda",
            "source": "tandem_tpu_torch/csrc/edge_kth.cu",
            "replaces": "tandem_tpu/ops/pallas_kernels.py:59",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def load_runner(dev):
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
    with open(UNIT / "model_config.json") as f:
        cfg = json.load(f)
    pack = np.load(UNIT / "sample_inputs.npz")
    V, H, W = pack["image"].shape[1], pack["image"].shape[3], \
        pack["image"].shape[4]
    runner = MvsnetRunner(CvaMVSNet(**cfg),
                          load_variables(UNIT / "model_variables.pkl"),
                          H, W, view_num=V, device=dev)
    return runner, pack


def phase_golden(runner, pack, dev):
    import torch

    from tandem_tpu_torch.ops.edge_kth import edge_kth_value
    before = edge_kth_value.launches
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
    worst, worst_key = 0.0, ""
    for s in ("stage1", "stage2", "stage3"):
        for f in ("depth", "confidence", "depth_dense", "confidence_dense"):
            got = getattr(getattr(out, s), f).cpu().numpy()
            if not np.isfinite(got).all():
                raise AssertionError(f"golden {s}.{f} is not finite")
            mae = float(np.abs(got - pack[f"out.{s}.{f}"]).mean())
            if mae > worst:
                worst, worst_key = mae, f"{s}.{f}"
    log(f"[golden] exported/tandem 640x480 V=7 f32: worst MAE {worst:.3e} "
        f"({worst_key}), first call {secs:.3f} s")
    if not worst < GOLDEN_TOL:
        raise AssertionError(f"golden MAE {worst:.3e} >= {GOLDEN_TOL}")
    if edge_kth_value.launches <= before:
        raise AssertionError("golden replay did not launch K1")
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


def phase_slice(runner, pack, dev, profile: Path = None):
    import torch

    from tandem_tpu_torch.mapping.tsdf import TsdfConfig
    from tandem_tpu_torch.ops.edge_kth import edge_kth_value
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    cfg = TsdfConfig()
    K = pack["K3"][0]
    H, W = runner.height, runner.width
    bgrs, poses, ref_pose = golden_window(pack)
    dmin, dmax = float(pack["depth_min"][0]), float(pack["depth_max"][0])
    backend = TandemBackend(runner, cfg, K, H, W, mesh_extraction_freq=0)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    edge_kth_value.launches = 0
    call_ms = []
    for _ in range(N_KEYFRAMES):
        t0 = time.perf_counter()
        backend.call(bgrs, poses, dmin, dmax, ref_pose)
        torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = edge_kth_value.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[slice] {N_KEYFRAMES} backend calls: K1 launches {launches}, "
        f"n_allocated {backend.stats()['n_allocated']}, peak memory "
        f"{peak_gb:.3f} GB, call ms {[round(x, 3) for x in call_ms]}")
    if launches < N_KEYFRAMES:
        raise AssertionError(f"K1 launched {launches} < {N_KEYFRAMES} times")

    rdepth = backend.get_tracking_depth_map()["depth"]
    mvs = runner.get_result(device=True)["depth"]
    rd, md = rdepth.cpu().numpy(), mvs.cpu().numpy()
    if rd.shape != (H, W) or not np.isfinite(rd).all() or (rd < 0).any():
        raise AssertionError("rendered depth not finite / non-negative")
    want = (md >= cfg.min_depth) & (md <= cfg.max_depth)
    hit = float((rd[want] > 0).mean())
    both = want & (rd > 0)
    med = float(np.median(np.abs(rd[both] - md[both])))
    log(f"[slice] render vs MVSNet depth: hit share {hit:.4f}, median "
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
        p.export_chrome_trace(str(profile / "keyframe_trace.json"))
    m, f = float(np.median(mvs_ms)), float(np.median(fuse_ms))
    log(f"[slice] per keyframe (host clock, synced, median of 5): MVSNet "
        f"{m:.3f} ms (of which host input packing alone "
        f"{float(np.median(pack_ms)):.3f} ms), fusion "
        f"(allocate+integrate+render) {f:.3f} ms, total {m + f:.3f} ms = "
        f"{1000.0 / (m + f):.3f} KF/s (reference GPU bar 201 ms/KF for the "
        f"MVSNet alone)")
    return launches


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
                    help="also profile one keyframe; write its trace here")
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

    kind = phase_device()
    phase_build()
    k1 = phase_kernels(dev)
    runner, pack = load_runner(dev)
    phase_golden(runner, pack, dev)
    k1["launches"] = phase_slice(runner, pack, dev, profile_dir)
    phase_wall(dev)
    kernels = {"kernels": [{k: k1[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms")}]}
    log(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
