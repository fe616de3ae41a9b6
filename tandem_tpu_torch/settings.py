"""Runtime settings and presets.

A copy of ``tandem_tpu/settings.py`` (the port imports nothing of the JAX
package). Parity target: tandem/src/util/settings.{h,cpp} (the ~120 setting_* knobs
that matter to this rebuild) and the preset bundles in
tandem/src/util/commandline.cpp:17-131 (dataset / gui / runtime / demo) plus
the key=value argument chain (:149-410). The strict-merge behaviour matches
the Python config system: unknown keys raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Settings:
    # --- core DSO knobs (settings.h:49-263) ---
    desired_immature_density: float = 1500.0
    desired_point_density: float = 2000.0
    min_frames: int = 5            # setting_minFrames
    max_frames: int = 7            # setting_maxFrames
    min_frame_age: int = 1         # setting_minFrameAge
    max_opt_iterations: int = 6
    min_opt_iterations: int = 1
    kf_global_weight: float = 1.0  # setting_kfGlobalWeight
    keyframes_per_second: float = 0.0  # setting_keyframesPerSecond
    # playbackSpeed (commandline.cpp speed= / preset): 0 => linearize mode
    # (backend waits, deterministic); >0 => real-time mode (backend drops
    # busy keyframes). main_tandem_pangolin.cpp:124.
    playback_speed: float = 0.0
    huber_th: float = 9.0
    coarse_cutoff_th: float = 20.0
    # photometric calibration mode: 0 = have calib, 1 = none (affine), 2 =
    # none + no exposure times (commandline.cpp mode handling :281-301)
    mode: int = 1
    # --- TANDEM knobs (settings.h:224-331) ---
    mvsnet_folder: str = ""
    mvsnet_flag: bool = False       # enabled iff mvsnet_folder set
    mvsnet_discard_percentage: float = 10.0
    tsdf_fusion: bool = True
    tracking_type: str = "dense"    # "sparse" | "dense"
    tracking_device: str = "tpu"    # reference: cpu | cuda
    tracking_step: int = 3          # setting_tracking_step
    dr_mvsnet_view_num: int = 7
    # Cascade program split: "mono" (one cascade jit), "staged" (per-stage
    # jits), "perview" (per-view warp programs + stage tail). All three are
    # mathematically identical (test_parity_model); the split modes exist
    # because XLA schedules a monolithic 640x480 program worse than its
    # parts (docs/PERF.md fusion-boundary lesson). v5e shootout
    # (experiments/bench_runner_modes.py, 2026-08-19): staged 164.7 ms/KF,
    # mono 174.1, perview 579 — staged ships as the default.
    mvsnet_staged: str = "staged"   # "mono" | "staged" | "perview"
    mesh_extraction_freq: int = 10
    dense_tracking_with_dense_depth_only: bool = False
    dr_timing: bool = False
    # Headless viewer parity: write per-KF [image | depth | confidence]
    # panels (pushDrKfImage/pushDrKfDepth rendering) under result_folder
    save_dr_video: bool = False
    # 3D viewer (PangolinDSOViewer substitute, pipeline/viewer.py):
    # interactive window when DISPLAY allows, else view3d_*.png recordings
    # under result_folder. Enabled by the gui preset like the reference.
    viewer3d: bool = False
    # --- debug observability ---
    # setting_logStuff: write logs/*.txt (nums/eigen/diagonal/variances/
    # nullspaces/coarseTracking/lifetime dumps, FullSystem.cpp:78-121)
    log_stuff: bool = False
    # debugSaveDepthImages + folders (settings.h:219-222): per-frame u16
    # depth PNGs + _scale.txt sidecars. Empty folder -> result_folder/depths.
    debug_save_depth_images: bool = False
    depth_save_folder: str = ""
    save_depth_scale: float = 1.0
    # --- runtime behaviour ---
    preload: bool = False
    quiet: bool = True
    nolog: bool = False
    reverse: bool = False
    start: int = 0
    end: int = 100000
    preset: str = "dataset"
    # RGB-D mode (rgbd_flag)
    rgbd: bool = False
    rgbd_depth_scale: float = 1.0
    # --- input/output paths (commandline.cpp files=/calib=/gamma=/vignette=
    # argument chain; result_folder replaces the hardcoded cwd outputs) ---
    files: str = ""
    calib: str = ""
    gamma: str = ""
    vignette: str = ""
    result_folder: str = "results"
    # --- demo main (main_tandem_realsense.cpp) ---
    camera: str = ""
    replay: str = ""
    demo_secs: float = 30.0
    record: str = ""     # capture the session as a dataset folder + calib


def preset(name: str) -> Settings:
    """Preset bundles, matched to commandline.cpp:17-131 exactly (all four
    share minFrames=5/maxFrames=7/6 opt iters; only demo is real-time)."""
    s = Settings(preset=name)
    if name == "dataset":
        # deterministic evaluation: no preload, linearized, no mesh
        s.preload = False
        s.playback_speed = 0.0
        s.tracking_type = "dense"
        s.mesh_extraction_freq = 0
    elif name == "runtime":
        # throughput run: preload images, dense tracking on the accelerator,
        # still linearized (commandline.cpp:79 playbackSpeed=0), no mesh
        s.preload = True
        s.playback_speed = 0.0
        s.tracking_type = "dense"
        s.tracking_device = "tpu"
        s.mesh_extraction_freq = 0
    elif name == "gui":
        s.preload = False
        s.playback_speed = 0.0
        s.mesh_extraction_freq = 5
        s.viewer3d = True
    elif name == "demo":
        # live camera: real-time enforcing => backend drops busy keyframes
        s.preload = False
        s.playback_speed = 1.0
        s.tracking_type = "dense"
        s.tracking_step = 2
        s.mesh_extraction_freq = 5
        s.mode = 1
    else:
        raise ValueError(f"Unknown preset {name}")
    return s


# Key types derive from the dataclass annotations so a newly added field
# can never silently parse as a string (a "0" value is truthy).
_BOOL_KEYS = {f.name for f in dataclasses.fields(Settings)
              if f.type in ("bool", bool)}
_INT_KEYS = {f.name for f in dataclasses.fields(Settings)
             if f.type in ("int", int)}
_FLOAT_KEYS = {f.name for f in dataclasses.fields(Settings)
               if f.type in ("float", float)}


def parse_arguments(argv, base: Optional[Settings] = None) -> Settings:
    """key=value chain; first arg may be preset=NAME (mandatory first in the
    reference)."""
    s = base
    rest = []
    for a in argv:
        if a.startswith("preset="):
            s = preset(a.split("=", 1)[1])
        else:
            rest.append(a)
    s = s or Settings()
    for a in rest:
        if "=" not in a:
            continue
        k, v = a.split("=", 1)
        if k == "tracking":
            # tracking=sparse | dense:cpu | dense:tpu (commandline.cpp:312)
            parts = v.split(":")
            s.tracking_type = parts[0]
            if len(parts) > 1:
                s.tracking_device = parts[1]
            continue
        if not hasattr(s, k):
            raise KeyError(f"Unknown setting {k}")
        if k in _BOOL_KEYS:
            setattr(s, k, v not in ("0", "false", "False"))
        elif k in _INT_KEYS:
            setattr(s, k, int(v))
        elif k in _FLOAT_KEYS:
            setattr(s, k, float(v))
        else:
            setattr(s, k, v)
    s.mvsnet_flag = bool(s.mvsnet_folder)
    if s.nolog:
        # commandline.cpp:190 nolog=1 -> setting_logStuff=false (the four
        # presets also force it off, :37/:63/:88/:113 — logging is opt-in)
        s.log_stuff = False
    if s.mvsnet_staged not in ("mono", "staged", "perview"):
        raise ValueError(f"mvsnet_staged must be mono|staged|perview, "
                         f"got {s.mvsnet_staged!r}")
    return s
