"""SLAM traffic: a camera's frames fed to ``FullSystem.add_active_frame`` in
a closed loop, one frame after the previous one returns.

The frames are the scene's periodic hand-held path (``traffic["path"]``),
rendered on the card at set-up and held in host memory as uint8 grey and
BGR arrays, as ``preload=1`` holds a sequence, and replayed as long as the
window lasts. The system is the one ``tandem_dataset preset=runtime``
builds: the unit's CVA-MVSNet in the configuration's dtype behind the
``TandemBackend``, dense tracking against the TSDF render, linearized.

Set-up runs the initializer and the first keyframes, until the backend has
fused ``traffic["setup_backend_calls"]`` windows, so the window is
steady-state tracking. Each frame's wall time is taken around
``add_active_frame``. A traced run (``--trace 1``) runs three phases in
place of the window, each on from where the last stopped: the host spans
(the program's Timer and the benchmark's wrappers) for ``seconds``, the
profiler for ``seconds``, and the sync counter for a third of that, so
that neither the profiler nor the sync counter's warnings slow the spans.

Correctness, once the window has closed and the program is freed: the
tracker never lost the camera; the tracked trajectory of the window's
frames (each frame's pose as tracking recorded it) against the scene's
exact poses, by the relative pose error between consecutive frames after
a similarity alignment; a seeded sample of the window's keyframe windows,
whose MVSNet depth and confidence the plain reference recomputes from the
same inputs (the views, and the poses and depth range that the program's
tracking and BA gave the backend); the fused TSDF against the plain
integrator's over the scans the program fused; and the depth the backend
rendered for the tracker at each sampled keyframe is not empty where the
scene has depth.
"""

from __future__ import annotations

import sys
import time

import torch

from ..harness import work
from ..harness.tracing import DeviceTrace, Spans, SyncCounter, Trace
from ..reference.trajectory import trajectory_errors
from . import common, scene


def run(ctx):
    """One run; returns the harness's ``Outcome`` fields (see run.py)."""
    from tandem_tpu_torch.pipeline import full_system as fsm
    from tandem_tpu_torch.settings import preset
    from tandem_tpu_torch.tracking import coarse_tracker
    from tandem_tpu_torch.utils.timer import Timer

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    path = tr["path"]
    cam = common.camera(cfg)
    period = path["period"]
    phase = ctx.seed % period
    bgrs, greys, _ = scene.render_frames(
        range(period), path, cam, scene.texture_offset(tr["decor_seed"]),
        dev)

    patches = common.Patches()
    timer = Timer(enabled=ctx.trace)
    runner, backend, scans = common.build_map_path(
        ctx.root, cfg, dev, patches, timer, ctx.control)
    if "tracker" in ctx.control:
        _lower_lm(coarse_tracker, patches, ctx.control["tracker"])
    s = preset(cfg["preset"])
    s.dr_mvsnet_view_num = cfg["views"]
    fs = fsm.FullSystem(cam.fx, cam.fy, cam.cx, cam.cy, cam.height,
                        cam.width, options=fsm.make_full_system_options(s),
                        backend=backend, timer=timer, device=dev)
    sample = common.AnswerSample(runner, backend, tr["sample_calls"],
                                 ctx.seed)

    frame = 0

    def feed():
        nonlocal frame
        f = (frame + phase) % period
        sample.frame_id = f
        fs.add_active_frame(greys[f], frame, frame / tr["fps"],
                            bgr=bgrs[f])
        frame += 1

    def window(seconds: float):
        """Frames in a closed loop for ``seconds``: (each frame's ms,
        the seconds taken)."""
        ms = []
        t0 = time.perf_counter()
        while True:
            ta = time.perf_counter()
            feed()
            tb = time.perf_counter()
            ms.append((tb - ta) * 1e3)
            if fs.is_lost or tb - t0 >= seconds:
                return ms, tb - t0

    while not (fs.initialized
               and backend.call_num >= tr["setup_backend_calls"]):
        feed()
        if fs.init_failed or fs.is_lost or frame > tr["setup_max_frames"]:
            raise RuntimeError(
                f"set-up did not reach steady tracking in {frame} frames "
                f"(initialized={fs.initialized}, lost={fs.is_lost}, "
                f"backend calls={backend.call_num})")
    runner.wait()
    torch.cuda.synchronize()

    spans, lm_calls = Spans(), []
    if ctx.trace:
        _instrument(fs, fsm, coarse_tracker, backend, spans, lm_calls,
                    patches)
    pose0, calls0, retracks0 = len(fs.all_poses), backend.call_num, \
        fs.n_retracks
    sample.on = True
    setup_s = time.time() - ctx.t_start
    host0 = common.host_snapshot()
    if ctx.trace:
        timed0 = {k: len(v) for k, v in timer.intervals.items()}
        frame_ms, frames_s = window(ctx.seconds)
        host = {k: v[timed0.get(k, 0):] for k, v in timer.intervals.items()}
        dtrace = DeviceTrace()
        calls1 = backend.call_num
        with dtrace:
            spans.on = True
            _, window_s = window(ctx.seconds)
            spans.on = False
        calls2 = backend.call_num
        with SyncCounter() as reads:
            n_read, _ = window(ctx.seconds / 3)
        n_read = len(n_read)
    else:
        frame_ms, frames_s = window(ctx.seconds)
    host1 = common.host_snapshot()
    sample.on = False
    lost = fs.is_lost
    runner.wait()
    torch.cuda.synchronize()
    poses = fs.all_poses[pose0:]
    truth = [scene.path_pose((i + phase) % period, path)
             for i in fs.all_ids[pose0:]]
    print(f"diag keyframe windows {backend.call_num - calls0}, "
          f"retracks {fs.n_retracks - retracks0}, "
          f"frames {len(poses)}, {common.host_share(host0, host1)}",
          file=sys.stderr)

    n = len(frame_ms)
    outcome = {
        "attempted": len(poses), "failed": int(lost),
        "e2e": {"fps": n / frames_s,
                "frame_ms_p95": common.percentile(frame_ms, 95),
                "setup_s": setup_s},
    }
    if ctx.trace:
        outcome["trace"] = Trace(
            window_s=window_s, kernels=dtrace.kernels(),
            spans={**host, "frame": frame_ms},
            counters={"frames": n_read, "host_reads": reads.count,
                      "backend_calls": calls2 - calls1},
            calls={"track_lm": _lm_work(lm_calls)},
            facts={"t0_ns": dtrace.t0_ns,
                   "t1_ns": dtrace.t1_ns, "mvsnet_ops": work.mvsnet_ops(
                       cfg["model"], cam.height, cam.width, cfg["views"]),
                   "dtype": cfg["dtype"]})
        outcome["host_spans"] = spans.items

    volume = None

    def release():
        nonlocal fs, volume
        sample.finish(runner)
        volume = common.program_volume(backend)
        fs = None
        backend.volume = None
        runner.model = runner._forward = None
        patches.undo()

    def check():
        got = {"lost": float(lost),
               **common.judge_sample(ctx.root, cfg, sample, dev, tr),
               **common.judge_fusion(cfg, scans, volume, dev, ctx.control)}
        if not lost:
            got.update(trajectory_errors(poses, truth))
        print("diag readings " + ", ".join(
            f"{k} {v!r}" for k, v in sorted(got.items())), file=sys.stderr)
        return [(k, got.get(k, float("nan")), lim)
                for k, lim in ctx.limits.items()]

    outcome["release"], outcome["check"] = release, check
    return outcome


def _lower_lm(coarse_tracker, patches, dtype: str):
    """The ``tracker`` control: each LM level call with its planes, its
    points' inverse depths and intensities, its candidates' poses and
    affine pairs rounded to ``dtype`` on the way in, and its answer's
    poses and affine pairs on the way out (the points' pixel coordinates
    stay exact)."""
    low = common.DTYPES[dtype]
    level = coarse_tracker._lm_level

    def rounded(x):
        return x.to(low).to(x.dtype)

    def lm_level(T, aff, pts, planes, Klvl, max_iter, tdist=False):
        pu, pv, pid, pcolor, pvalid = pts
        out = level(rounded(T), rounded(aff),
                    (pu, pv, rounded(pid), rounded(pcolor), pvalid),
                    tuple(rounded(p) for p in planes), Klvl, max_iter, tdist)
        return (rounded(out[0]), rounded(out[1])) + tuple(out[2:])
    patches.set(coarse_tracker, "_lm_level", lm_level)


def _instrument(fs, fsm, coarse_tracker, backend, spans, lm_calls, patches):
    """The traced run's spans around the calls into each layer, and the
    record of each LM level call's inputs for its roofline."""
    cls = type(fs)
    for owner, attr, name in (
            (cls, "add_active_frame", "frame"),
            (cls, "_make_keyframe", "make_keyframe"),
            (cls, "_trace_on_frame", "trace"),
            (fsm, "track_frame", "track_frame"),
            (fsm, "track_frame_multi", "track_retry"),
            (fsm, "ba_iterate", "ba"),
            (backend, "call", "backend_call"),
            (backend, "_fuse_previous", "fusion")):
        patches.set(owner, attr, spans.wrapped(getattr(owner, attr), name))
    level = coarse_tracker._lm_level

    def lm_level(T, aff, pts, planes, Klvl, max_iter, tdist=False):
        out = level(T, aff, pts, planes, Klvl, max_iter, tdist)
        if spans.on:
            lm_calls.append((T.shape[0], pts, planes[0].shape, out[4]))
        return out
    patches.set(coarse_tracker, "_lm_level", lm_level)


def _lm_work(lm_calls):
    """(bytes, operations) of each recorded LM level call."""
    out = []
    for B, pts, (H, W), it in lm_calls:
        out.append(work.track_lm_work(B, pts[0].shape[0], int(pts[4].sum()),
                                      H, W, int(it) + 1))
    return out
