"""Keyframe-stream traffic: keyframe windows fed to ``TandemBackend.call``
back to back, in the two-deep pipeline ``FullSystem`` drives (call N fuses
call N - 1's depth and renders the tracker's map, then enqueues N's MVSNet).

Keyframe j is frame ``j * traffic["keyframe_every"]`` of the scene's
periodic path, with its exact pose; a call is the window of the newest
``views`` keyframes, and its depth range is ``_deliver_dr_frame``'s rule,
[0.01, 3 / (the 20% quantile of the inverse depths)], on the exact inverse
depths of the window's reference view. The path is periodic, so the
keyframes repeat, and set-up fuses one whole cycle: the TSDF's blocks are
allocated before the window, as in a room being revisited.

Correctness, once the window has closed and the program is freed: a seeded
sample of the window's calls, whose MVSNet depth and confidence after the
edge filter the plain reference recomputes from the same inputs; the fused
TSDF, set-up's scans and the window's, against the plain integrator's over
the same scans (the depths and poses the program fused); and the depth the
backend rendered at the next keyframe from the map that holds the sampled
call's depth is not empty where the scene has depth.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from ..harness import work
from ..harness.tracing import DeviceTrace, EventSpans, Spans, Trace
from . import common, scene


def _idepth_quantile(idepth: np.ndarray, fraction: float) -> float:
    """The element at index int(fraction * n) of the sorted inverse depths
    (tandem_backend.cpp's get_idepth_quantile)."""
    k = min(max(int(fraction * float(len(idepth))), 0), len(idepth) - 1)
    return float(np.partition(idepth, k)[k])


def run(ctx):
    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    path = tr["path"]
    cam = common.camera(cfg)
    offset = scene.texture_offset(tr["decor_seed"])
    every, V = tr["keyframe_every"], cfg["views"]
    cycle = path["period"] // math.gcd(path["period"], every)
    frames = [(j * every) % path["period"] for j in range(cycle)]
    bgrs, _, depths = scene.render_frames(frames, path, cam, offset, dev)
    dmax = []
    for d in depths.cpu().numpy():
        idv = (1.0 / d[d > 0]).astype(np.float32)
        dmax.append(3.0 / max(_idepth_quantile(idv, 0.2), 1e-3))
    del depths
    poses = [scene.path_pose(f, path).astype(np.float32) for f in frames]

    patches = common.Patches()
    runner, backend, scans = common.build_map_path(
        ctx.root, cfg, dev, patches, control=ctx.control)
    sample = common.AnswerSample(runner, backend, tr["sample_calls"],
                                 ctx.seed)
    k = ctx.seed % cycle          # where on the cycle the stream starts

    def call():
        nonlocal k
        window = [(k - V + 1 + i) % cycle for i in range(V)]
        sample.frame_id = frames[window[-1]]
        backend.call(bgrs=[bgrs[j] for j in window],
                     cam_to_worlds=[poses[j] for j in window],
                     depth_min=0.01, depth_max=dmax[window[-2]],
                     next_ref_c2w=poses[window[-1]],
                     discard_percentage=tr["discard_percentage"])
        k += 1

    for _ in range(cycle + V):
        call()
    runner.wait()
    torch.cuda.synchronize()

    spans, events = Spans(), EventSpans()
    if ctx.trace:
        _instrument(backend, runner, spans, events, patches)
    sample.on = True
    calls0 = k
    setup_s = time.time() - ctx.t_start
    dtrace = DeviceTrace() if ctx.trace else None
    if dtrace:
        dtrace.__enter__()
        spans.on = True
    host0 = common.host_snapshot()
    t0 = time.perf_counter()
    while True:
        call()
        t1 = time.perf_counter()
        if t1 - t0 >= ctx.seconds:
            break
    window_s = t1 - t0
    print(f"diag {common.host_share(host0, common.host_snapshot())}",
          file=sys.stderr)
    if dtrace:
        spans.on = False
        dtrace.__exit__(None, None, None)
    sample.on = False
    runner.wait()
    torch.cuda.synchronize()

    # Each call in the window fused the previous call's keyframe window.
    fused = k - calls0
    outcome = {"attempted": fused, "failed": 0,
               "e2e": {"kf_per_s": fused / window_s, "setup_s": setup_s},
               "window_s": window_s}
    if ctx.trace:
        outcome["trace"] = Trace(
            window_s=window_s, kernels=dtrace.kernels(),
            spans={"mvsnet": events.ms("mvsnet"),
                   "fusion": events.ms("fusion")},
            counters={"backend_calls": fused},
            facts={"t0_ns": dtrace.t0_ns,
                   "t1_ns": dtrace.t1_ns, "dtype": cfg["dtype"],
                   "mvsnet_ops": work.mvsnet_ops(cfg["model"], cam.height,
                                                 cam.width, V),
                   "stage_shapes": work.stage_shapes(cfg["model"],
                                                     cam.height, cam.width)})
        outcome["host_spans"] = spans.items

    volume = None

    def release():
        nonlocal volume
        sample.finish(runner)
        volume = common.program_volume(backend)
        backend.volume = None
        runner.model = runner._forward = None
        patches.undo()

    def check():
        got = {**common.judge_sample(ctx.root, cfg, sample, dev, tr),
               **common.judge_fusion(cfg, scans, volume, dev, ctx.control)}
        print("diag readings " + ", ".join(
            f"{k} {v!r}" for k, v in sorted(got.items())), file=sys.stderr)
        return [(name, got.get(name, float("nan")), limit)
                for name, limit in ctx.limits.items()]

    outcome["release"], outcome["check"] = release, check
    return outcome


def _instrument(backend, runner, spans, events, patches):
    """The traced run's spans: host spans around the backend's call and its
    fusion, and CUDA events around each keyframe's MVSNet forward with the
    edge filter (on the runner's stream) and around the fusion (from the
    moment its stream has the MVSNet's answer to the render's end)."""
    for owner, attr, name in ((backend, "call", "backend_call"),
                              (backend, "_fuse_previous", "fusion"),
                              (runner, "call_async", "mvsnet_enqueue")):
        patches.set(owner, attr, spans.wrapped(getattr(owner, attr), name))
    run_, fuse, get_result = (runner._run, backend._fuse_previous,
                              runner.get_result)

    def timed_run(*args):
        if not spans.on:
            return run_(*args)
        events.start("mvsnet")
        out = run_(*args)
        events.end("mvsnet")
        return out

    def timed_result(device: bool = False):
        res = get_result(device=device)
        if spans.on:
            events.start("fusion")
        return res

    def timed_fuse(next_ref_c2w):
        res = fuse(next_ref_c2w)
        if spans.on:
            events.end("fusion")
        return res
    patches.set(runner, "_run", timed_run)
    patches.set(runner, "get_result", timed_result)
    patches.set(backend, "_fuse_previous", timed_fuse)
