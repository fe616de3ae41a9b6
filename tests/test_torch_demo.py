"""The port's real-time paths on the CPU: ``tandem_demo`` (replay and
record), the read routes of ``tandem_dataset`` (the prefetcher and
``preload=1``) and the real-time keyframe drop.

- tests/test_cli.py's record/replay case on the port; the recorded folder
  replays through tandem_dataset to the demo's poses: poses_dso.txt equal
  byte for byte and result.txt equal in every pose column (its timestamps
  go through times.txt's six decimals, the JAX recorder's format, so they
  agree to 5e-7 s). The replay passes desired_immature_density=512, the
  demo's default FullSystem capacity.
- The JAX demo records the same 10 frames: camera.txt and times.txt are
  equal byte for byte, the recorded images decode to the same pixels, the
  two FullSystems get the same options, and every pose in poses_dso.txt
  agrees within tests/test_torch_full_system.py's POSE_TOL (1e-4 in
  rotation entries and metres).
- ``preload=1`` gives the same result.txt as the default route on a
  replica_traj prefix.
- tests/test_tandem_loop.py's drop/wait case through the port's FullSystem
  with the oracle runner made busy: real-time mode drops keyframes while
  the backend is busy, linearize mode waits and drops none. The demo keeps
  the JAX demo's default options (linearize) unless ``realtime_drop=1``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tandem_tpu_torch.cli import tandem_dataset, tandem_demo
from tandem_tpu_torch.data.replica import read_png, write_png
from tandem_tpu_torch.mapping.tsdf import TsdfConfig
from tandem_tpu_torch.pipeline.backend import TandemBackend
from tandem_tpu_torch.pipeline.full_system import (FullSystem,
                                                   FullSystemOptions)
from tests.test_coarse_tracker import CX, CY, FX, FY, H, W
from tests.test_full_system import make_sequence
from tests.test_torch_full_system import POSE_TOL
from tests.test_torch_tandem_loop import TSDF, OracleRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ = os.path.join(REPO, "tests", "fixtures", "replica_traj", "scene0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this module: the tier-1 run puts six pytest
    workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_image_folder(tmp_path, n=10):
    img_dir = tmp_path / "images"
    os.makedirs(img_dir, exist_ok=True)
    _, images = make_sequence(n=n, step=0.02)
    for i, img in enumerate(images):
        write_png(img_dir / f"{i:06d}.png",
                  np.stack([img] * 3, -1).astype(np.uint8))
    calib = tmp_path / "camera.txt"
    calib.write_text(f"Pinhole {FX} {FY} {CX} {CY} 0\n{W} {H}\n")
    return img_dir, calib


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    """The port's and the JAX package's demo, each recording the same 10
    frames: {"t" | "j": (session folder, result folder, FullSystem)}, and
    the port's result dict."""
    import tests.conftest  # noqa: F401  (JAX on the CPU)
    from tandem_tpu.cli import tandem_demo as jdemo
    from tandem_tpu.pipeline import full_system as jfs

    tmp_path = tmp_path_factory.mktemp("demo")
    img_dir, calib = _write_image_folder(tmp_path, n=10)
    runs = {}
    res = tandem_demo.main([f"replay={img_dir}", f"calib={calib}",
                            "demo_secs=300", f"record={tmp_path / 't_rec'}",
                            f"result_folder={tmp_path / 't_out'}",
                            "device=cpu"])
    runs["t"] = (tmp_path / "t_rec", tmp_path / "t_out", res["fs"])
    built = []

    class Capture(jfs.FullSystem):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)
    mp = pytest.MonkeyPatch()
    mp.setattr(jfs, "FullSystem", Capture)
    try:
        jdemo.main([f"replay={img_dir}", f"calib={calib}", "demo_secs=300",
                    f"record={tmp_path / 'j_rec'}",
                    f"result_folder={tmp_path / 'j_out'}"])
    finally:
        mp.undo()
    runs["j"] = (tmp_path / "j_rec", tmp_path / "j_out", built[0])
    return runs, res


def test_demo_matches_the_jax_demo(demos):
    runs, _ = demos
    (t_rec, t_out, t_fs), (j_rec, j_out, j_fs) = runs["t"], runs["j"]
    for name in ("camera.txt", "times.txt"):
        assert (t_rec / name).read_bytes() == (j_rec / name).read_bytes()
    names = sorted(os.listdir(t_rec / "images"))
    assert names == sorted(os.listdir(j_rec / "images")) and len(names) == 10
    for name in names:
        a, b = (read_png(r / "images" / name) for r in (t_rec, j_rec))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert dataclasses.asdict(t_fs.opt) == dataclasses.asdict(j_fs.opt)
    t_poses, j_poses = (np.loadtxt(o / "poses_dso.txt", ndmin=2)
                        for o in (t_out, j_out))
    assert t_poses.shape == j_poses.shape and len(t_poses) == 10
    diff = np.abs(t_poses - j_poses).max()
    print(f"largest pose difference from the JAX demo {diff:.2e}")
    assert diff < POSE_TOL, diff


def test_tandem_demo_record_replay(demos, tmp_path):
    """The captured folder is dataset-compatible (calib + times + images)
    and replays through tandem_dataset to the demo's poses."""
    runs, res = demos
    rec, out, _ = runs["t"]
    assert res["frames"] == 10 and res["fs"].opt.linearize
    assert (out / "result.txt").exists()
    assert (rec / "camera.txt").exists()
    times = (rec / "times.txt").read_text().strip().splitlines()
    imgs = sorted(os.listdir(rec / "images"))
    assert len(times) == len(imgs) == 10
    first = (rec / "camera.txt").read_text().splitlines()[0].split()
    assert first[0] == "Pinhole" and float(first[1]) == FX
    for name in imgs:                              # lossless capture
        a = open(rec / "images" / name, "rb").read()
        assert a[:8] == b"\x89PNG\r\n\x1a\n"

    replay = tmp_path / "replay_out"
    tandem_dataset.main([f"files={rec / 'images'}",
                         f"calib={rec / 'camera.txt'}",
                         f"result_folder={replay}",
                         "desired_immature_density=512", "device=cpu"])
    assert ((replay / "poses_dso.txt").read_bytes()
            == (out / "poses_dso.txt").read_bytes())
    a = [ln.split() for ln in (out / "result.txt").read_text().splitlines()]
    b = [ln.split() for ln in
         (replay / "result.txt").read_text().splitlines()]
    assert [r[1:] for r in a] == [r[1:] for r in b]
    np.testing.assert_allclose([float(r[0]) for r in a],
                               [float(r[0]) for r in b], atol=5e-7)


def test_demo_options_and_camera(tmp_path):
    img_dir, calib = _write_image_folder(tmp_path, n=3)
    res = tandem_demo.main([f"replay={img_dir}", f"calib={calib}",
                            f"result_folder={tmp_path / 'o'}",
                            "realtime_drop=1", "device=cpu"])
    assert not res["fs"].opt.linearize          # preset=demo's real time
    assert res["fs"].opt.tracking_step == 2
    with pytest.raises(NotImplementedError, match="OpenCV"):
        tandem_demo.main(["camera=0", f"result_folder={tmp_path / 'c'}",
                          "device=cpu"])
    with pytest.raises(KeyError):
        tandem_demo.main([f"replay={img_dir}", f"calib={calib}",
                          "bogus_key=1", "device=cpu"])


def test_preload_gives_the_same_result(tmp_path):
    """tandem_dataset through the prefetcher and with preload=1 on the
    first frames of replica_traj (VO only)."""
    outs = []
    for tag, extra in (("prefetch", []), ("preload", ["preload=1"])):
        out = tmp_path / tag
        res = tandem_dataset.main(
            [f"files={os.path.join(TRAJ, 'images')}",
             f"calib={os.path.join(TRAJ, 'camera_dso.txt')}",
             f"result_folder={out}", "end=10", "dr_timing=1",
             "desired_point_density=256", "desired_immature_density=256",
             "max_frames=4", "device=cpu", *extra])
        assert res["frames"] == 10
        assert len(res["timer"].intervals["read_frame"]) == 10
        outs.append((out / "result.txt").read_bytes())
    assert outs[0] == outs[1]


class BusyOracle(OracleRunner):
    """The oracle whose device never finishes by probe time while a call
    is pending (tests/test_tandem_loop.py's busy=True)."""

    def device_ready(self):
        return self._pending is None


def _drive(linearize: bool):
    _, images = make_sequence(n=22, step=0.02)
    K_mat = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    backend = TandemBackend(BusyOracle(), TsdfConfig(**TSDF), K_mat, H, W,
                            mesh_extraction_freq=0)
    opts = FullSystemOptions(selection_threshold_factor=0.35,
                             kf_global_weight=7.0, init_max_width=0.4,
                             mvs_view_num=4, max_keyframes=4,
                             num_point_slots=256, immature_cap=256,
                             linearize=linearize)
    fs = FullSystem(FX, FY, CX, CY, H, W, options=opts, backend=backend,
                    device="cpu")
    for i, img in enumerate(images):
        fs.add_active_frame(img, i, float(i) * 0.1,
                            bgr=np.stack([img] * 3, -1).astype(np.uint8))
    return fs, backend


def test_backend_drop_and_wait_modes():
    """FullSystem.cpp:1144-1151: real-time mode drops keyframes while the
    backend is busy; linearize mode waits, so none is dropped."""
    fs, backend = _drive(linearize=False)
    assert fs.initialized
    assert backend.call_num == 1          # the first window launches
    assert fs.n_dropped_kf >= 1
    fs2, backend2 = _drive(linearize=True)
    assert fs2.initialized
    assert fs2.n_dropped_kf == 0
    assert backend2.call_num >= 2
