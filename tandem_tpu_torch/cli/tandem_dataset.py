"""Runtime CLI: the reference's tandem_dataset, headless, on the card.

Port of ``tandem_tpu/cli/tandem_dataset.py``. Runs the TANDEM pipeline
over an image folder: per-frame dense coarse tracking, keyframe windowed
BA, CVA-MVSNet depth (bfloat16), TSDF fusion with the rendered depth fed
back to the tracker, and the mesh. Writes result.txt / poses_dso.txt /
keyframes_dso.txt / dso_optimization_windows.txt, mesh.obj with a unit and
dr_times.txt with dr_timing=1 (main_tandem_pangolin.cpp's output
contract), and prints the TANDEM TIMING block. Frames are decoded by the
host library's C decoder: read ahead on a worker thread, or all up front
with ``preload=1`` (``preset=runtime``); the Timer's ``read_frame`` is the
loop's wait for them.

Usage:
  python -m tandem_tpu_torch.cli.tandem_dataset preset=dataset \\
      files=IMG_DIR calib=CAMERA.txt result_folder=OUT \\
      [mvsnet_folder=EXPORTED_DIR] [end=N] [device=cpu]

It runs on the card; ``device=cpu`` (this port's own key, not a DSO
setting) runs it on the CPU. ``rgbd=1`` means what it means in the JAX
CLI, which reads no depth: monocular tracking with the Student-t weights
(``track_frame(..., tdist=True)``); the dvo RGB-D tracker runs through the
API (``FullSystem.add_active_frame(..., depth=)``). ``log_stuff=1``
writes result_folder/logs, ``debug_save_depth_images=1`` the depth dumps,
``save_dr_video=1`` the keyframe panels under result_folder/dr_video (with
a unit) and ``viewer3d=1`` the headless 3D viewer's PNGs under
result_folder/view3d and view3d_final.png. A unit that holds only
model.stablehlo is not ported (NotImplementedError).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np


def parse_args(argv):
    """Strict key=value argument chain (commandline.cpp:149-410): unknown
    keys raise KeyError."""
    from ..settings import parse_arguments, preset
    return parse_arguments(argv, base=preset("dataset"))


def read_calib(path):
    """DSO camera.txt: a plain pinhole file's intrinsics and size; for a
    distortion-model calib the rectified pinhole intrinsics and output size
    (the reader undistorts each frame)."""
    lines = [ln.strip() for ln in open(path)
             if ln.strip() and not ln.startswith("#")]
    parts = lines[0].split()
    model = parts[0].lower()
    simple_pinhole = (model == "pinhole"
                      and (len(lines) < 3 or lines[2].split()[0] == "none"))
    if simple_pinhole:
        fx, fy, cx, cy = [float(x) for x in parts[1:5]]
        w, h = [int(x) for x in lines[1].split()[:2]]
        return fx, fy, cx, cy, w, h
    from ..data.undistort import Undistort
    und = Undistort.from_file(path)
    return (float(und.K[0, 0]), float(und.K[1, 1]), float(und.K[0, 2]),
            float(und.K[1, 2]), und.w, und.h)


def playback_gate(target: float, since_start: float, frame_parity: int):
    """Timed-playback decision (main_tandem_pangolin.cpp:216-228):
    ('sleep', seconds) when ahead of schedule, ('skip', lateness) when more
    than 0.5 + 0.1*(parity) s behind, else ('ok', 0.0)."""
    if since_start < target:
        return "sleep", target - since_start
    late = since_start - target
    if late > 0.5 + 0.1 * (frame_parity % 2):
        return "skip", late
    return "ok", 0.0


def split_port_keys(argv, keys=("device",)):
    """Take this port's own ``key=value`` arguments (not DSO settings) out
    of the argument chain: (the rest, {key: value})."""
    rest, found = [], {}
    for a in argv:
        key = a.split("=", 1)[0]
        if "=" in a and key in keys:
            found[key] = a.split("=", 1)[1]
        else:
            rest.append(a)
    return rest, found


def main(argv=None, device=None):
    """:param device: the card unless given (or ``device=`` in argv).
    :return: dict with frames, seconds, the FullSystem, the backend and
        the Timer."""
    argv, port_keys = split_port_keys(argv if argv is not None
                                      else sys.argv[1:])
    s = parse_args(argv)
    assert s.files, "files=IMG_DIR required"
    assert s.calib, "calib=CAMERA.txt required"

    import torch

    from ..data.reader import ImageFolderReader
    from ..mapping.mesh import save_obj
    from ..mapping.tsdf import TsdfConfig
    from ..models.convert import load_variables
    from ..models.cva_mvsnet import CvaMVSNet
    from ..pipeline.backend import TandemBackend
    from ..pipeline.full_system import (FullSystem, make_full_system_options,
                                        resolve_device)
    from ..pipeline.mvsnet_runner import MvsnetRunner
    from ..pipeline.output_wrapper import PanelOutputWrapper
    from ..pipeline.viewer import Viewer3DWrapper
    from ..utils.timer import Timer
    from .golden import GOLDEN_TOL, load_model_config, verify_golden

    dev = resolve_device(device or port_keys.get("device"))
    fx, fy, cx, cy, W, H = read_calib(s.calib)
    K_mat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    timer = Timer(enabled=bool(s.dr_timing))

    backend = None
    if s.mvsnet_folder:
        pkl = os.path.join(s.mvsnet_folder, "model_variables.pkl")
        pack = os.path.join(s.mvsnet_folder, "sample_inputs.npz")
        if not os.path.exists(pkl):
            raise NotImplementedError(
                f"{s.mvsnet_folder} holds no model_variables.pkl: serving a "
                "model.stablehlo unit alone is not ported (ROADMAP, not "
                "ported by design)")
        variables = load_variables(pkl)
        model = CvaMVSNet(**load_model_config(s.mvsnet_folder),
                          dtype=torch.bfloat16)
        runner = MvsnetRunner(model, variables, H, W,
                              view_num=s.dr_mvsnet_view_num, device=dev)
        # Boot-time golden self-check (FullSystem initDr, dr_mvsnet_test).
        if os.path.exists(pack):
            err = verify_golden(pack, variables, dev)
            print(f"MVSNet golden self-check: {err:.2e}")
            assert err < 10 * GOLDEN_TOL
        backend = TandemBackend(runner, TsdfConfig(), K_mat, H, W,
                                mesh_extraction_freq=s.mesh_extraction_freq,
                                timer=timer)
        if s.save_dr_video:
            backend.output_wrappers.append(PanelOutputWrapper(
                os.path.join(s.result_folder, "dr_video")))

    outputs = []
    viewer = None
    if s.viewer3d:
        # PangolinDSOViewer substitute, headless: PNG recordings.
        viewer = Viewer3DWrapper(
            K=(fx, fy, cx, cy),
            out_dir=os.path.join(s.result_folder, "view3d"))
        outputs.append(viewer)
        if backend is not None:
            backend.output_wrappers.append(viewer)

    opts = make_full_system_options(s)
    fs = FullSystem(fx, fy, cx, cy, H, W, options=opts, backend=backend,
                    timer=timer, outputs=outputs, device=dev)

    with open(s.calib) as f:
        clines = [ln.strip() for ln in f if ln.strip()]
    needs_undistort = ((len(clines) >= 3 and clines[2].split()[0] != "none")
                       or clines[0].split()[0].lower() != "pinhole")
    reader = ImageFolderReader(
        s.files, calib=s.calib if needs_undistort else None,
        gamma=s.gamma or None, vignette=s.vignette or None,
        preload=s.preload)

    end = min(s.end, len(reader)) if s.end >= 0 else len(reader)
    indices = list(range(s.start, end))
    if s.reverse:
        indices.reverse()

    # Timed playback (main_tandem_pangolin.cpp:216-228): speed=0 processes
    # every frame (linearize mode).
    times_to_play = None
    if s.playback_speed > 0:
        stamps = [reader.get_timestamp(ii) for ii in indices]
        times_to_play = [(t - stamps[0]) / s.playback_speed for t in stamps]

    t_start = time.time()
    init_offset = 0.0
    for ii, i in enumerate(indices):
        if times_to_play is not None and not fs.initialized:
            # Initialization time does not count against playback.
            t_start = time.time()
            init_offset = times_to_play[ii]
        tid = timer.start_timing("read_frame")
        gray, ts, _ = reader.get_image(i)
        bgr = reader.get_image_bgr(i)
        timer.end_timing("read_frame", tid)
        if times_to_play is not None:
            since_start = init_offset + (time.time() - t_start)
            target = times_to_play[ii]
            action, amount = playback_gate(target, since_start, ii)
            if action == "sleep":
                time.sleep(amount)
            elif action == "skip":
                print(f"SKIPFRAME {ii} (play at {target:.3f}, now it is "
                      f"{since_start:.3f})!")
                continue
        fs.add_active_frame(gray, i, ts, bgr=bgr)
        # Auto-reset within the first 250 frames on init failure or early
        # loss (main_tandem_pangolin.cpp:237-255).
        if (fs.init_failed or fs.is_lost) and i < 250:
            print(f"RESETTING at frame {i} (init_failed={fs.init_failed})")
            fs = FullSystem(fx, fy, cx, cy, H, W, options=opts,
                            backend=backend, timer=timer, device=dev)
            continue
        if fs.is_lost:
            print(f"LOST at frame {i}")
            break
    elapsed = time.time() - t_start
    reader.close()

    out = s.result_folder
    os.makedirs(out, exist_ok=True)
    fs.write_results(out)
    if backend is not None:
        verts, faces, cols = backend.extract_mesh_now()
        save_obj(os.path.join(out, "mesh.obj"), verts, faces, cols)
    if s.dr_timing:
        timer.write_to_file(os.path.join(out, "dr_times.txt"))
    if viewer is not None:
        # Final scene snapshot (viewer->join, main:267).
        viewer.snapshot(os.path.join(out, "view3d_final.png"))
        viewer.join()

    n = len(fs.all_poses)
    # End-of-run FPS block (main_tandem_pangolin.cpp:276-283)
    print("=" * 30 + " TANDEM TIMING " + "=" * 30)
    print(f"Frames: {n}; Time: {elapsed:.2f} s; "
          f"FPS: {n / max(elapsed, 1e-9):.2f}")
    return {"frames": n, "seconds": elapsed, "fs": fs, "backend": backend,
            "timer": timer}


if __name__ == "__main__":
    main()
