"""Demo CLI: the tandem_demo (realsense) equivalent, on the card.

Port of ``tandem_tpu/cli/tandem_demo.py``. Runs the full TANDEM pipeline
over a replayed image folder for ``demo_secs`` seconds
(main_tandem_realsense.cpp:162-190 loop semantics), then writes the
results and, with a unit, the mesh. A live camera needs OpenCV, which the
port does not use (``pipeline/camera.OpenCVCamera`` raises).

Usage:
  python -m tandem_tpu_torch.cli.tandem_demo replay=IMG_DIR calib=camera.txt \\
      [mvsnet_folder=DIR] [result_folder=OUT] [record=SESSION_DIR] \\
      [demo_secs=30] [device=cpu] [realtime_drop=1]

``record=DIR`` also captures the session as a dataset folder (images/,
times.txt and camera.txt from the camera's intrinsics), which replays
through tandem_dataset; a writer thread encodes the PNGs
(``data/replica.write_png``) off the tracking loop. The unit runs in
bfloat16, as in tandem_dataset. ``device=`` and ``realtime_drop=`` are this
port's own keys, taken out of the DSO argument chain.

As in the JAX demo, FullSystem is built with its default options, so
preset=demo's playback_speed=1.0 never reaches ``linearize`` and a busy
backend is waited for instead of its keyframe being dropped (ROADMAP
Queue 3). ``realtime_drop=1`` passes the settings' options
(``make_full_system_options``), which drop it.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time

import numpy as np


def main(argv=None, device=None):
    """:param device: the card unless given (or ``device=`` in argv).
    :return: dict with frames, seconds, the FullSystem and the backend."""
    from ..settings import parse_arguments, preset
    from .tandem_dataset import read_calib, split_port_keys
    argv, port_keys = split_port_keys(
        argv if argv is not None else sys.argv[1:],
        ("device", "realtime_drop"))
    s = parse_arguments(argv, base=preset("demo"))
    s.result_folder = (s.result_folder if s.result_folder != "results"
                       else "demo_results")

    import torch

    from ..data.replica import gray, write_png
    from ..mapping.mesh import save_obj
    from ..mapping.tsdf import TsdfConfig
    from ..models.convert import load_variables
    from ..models.factory import build_model
    from ..pipeline.backend import TandemBackend
    from ..pipeline.camera import OpenCVCamera, ReplayCamera
    from ..pipeline.full_system import (FullSystem, make_full_system_options,
                                        resolve_device)
    from ..pipeline.mvsnet_runner import MvsnetRunner
    from .golden import load_model_config

    dev = resolve_device(device or port_keys.get("device"))
    if s.replay:
        assert s.calib, "replay needs calib="
        fx, fy, cx, cy, W, H = read_calib(s.calib)
        cam = ReplayCamera(s.replay, (fx, fy, cx, cy))
    else:
        cam = OpenCVCamera(int(s.camera or 0))
    fx, fy, cx, cy, W, H = cam.intrinsics()

    backend = None
    if s.mvsnet_folder:
        variables = load_variables(os.path.join(s.mvsnet_folder,
                                                "model_variables.pkl"))
        model = build_model(load_model_config(s.mvsnet_folder),
                            torch.bfloat16)
        runner = MvsnetRunner(model, variables, H, W,
                              view_num=s.dr_mvsnet_view_num, device=dev)
        K_mat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        backend = TandemBackend(runner, TsdfConfig(), K_mat, H, W)

    # Session recorder: a dataset folder that replays through
    # tandem_dataset; PNG encoding on a writer thread, off the loop.
    rec_times = rec_queue = rec_thread = None
    if s.record:
        os.makedirs(os.path.join(s.record, "images"), exist_ok=True)
        cam.write_calib(os.path.join(s.record, "camera.txt"))
        rec_times = []
        rec_queue = queue.Queue(maxsize=64)

        def _writer():
            while True:
                item = rec_queue.get()
                if item is None:
                    return
                idx, frame = item
                write_png(os.path.join(s.record, "images", f"{idx:06d}.png"),
                          np.ascontiguousarray(frame[..., ::-1]))
        rec_thread = threading.Thread(target=_writer, daemon=True)
        rec_thread.start()

    opts = (make_full_system_options(s)
            if int(port_keys.get("realtime_drop", 0)) else None)
    fs = FullSystem(fx, fy, cx, cy, H, W, options=opts, backend=backend,
                    device=dev)
    t0 = time.time()
    n = 0
    try:
        for bgr, ts in cam.frames():
            if time.time() - t0 > s.demo_secs:
                break
            if rec_times is not None:
                rec_queue.put((n, bgr.copy()))
                rec_times.append((n, ts))
            fs.add_active_frame(gray(bgr).astype(np.float32), n, ts, bgr=bgr)
            n += 1
            if fs.is_lost:
                print("tracking lost")
                break
    finally:
        if rec_thread is not None:
            rec_queue.put(None)
            rec_thread.join()
    elapsed = time.time() - t0

    if rec_times is not None:
        with open(os.path.join(s.record, "times.txt"), "w") as f:
            for i, ts in rec_times:
                f.write(f"{i:06d} {ts:.6f} 1.0\n")

    os.makedirs(s.result_folder, exist_ok=True)
    fs.write_results(s.result_folder)
    if backend is not None:
        verts, faces, cols = backend.extract_mesh_now()
        save_obj(os.path.join(s.result_folder, "mesh.obj"),
                 verts, faces, cols)
    print(f"demo: {n} frames in {time.time() - t0:.1f}s")
    return {"frames": n, "seconds": elapsed, "fs": fs, "backend": backend}


if __name__ == "__main__":
    main()
