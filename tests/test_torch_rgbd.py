"""RGB-D mode of the port's FullSystem (the dvo dense tracker on level 1,
sensor-depth seeding) and its RGB-D reader against the JAX package, on the
CPU.

- tests/test_rgbd.py's bar on the port: metric-scale VO on the synthetic
  plane sequence (10 frames, sensor depth rendered exactly), translations
  within 0.02 m of the truth without scale alignment;
- the port's and the JAX package's FullSystem(rgbd=True) over the same
  sequence: every frame's pose within 1e-3 (translation in m, rotation
  entries; the BA and dvo sums run in another order; measured 2.5e-4),
  and the same frames keep dvo's pose (no fallback, no retry ladder);
- a keyframe without depth drops the dvo reference, and the next frame
  takes the track_frame path;
- ``tandem_dataset rgbd=1`` (which reads no depth, as the JAX CLI: the
  Student-t monocular tracker) on the first 12 frames of
  tests/fixtures/replica_traj: result.txt within 1e-4 of the JAX CLI's in
  every number (measured 3e-6 over these frames; the JAX package's poses
  drift off SO(3) over longer runs, see test_torch_vo_ate.py);
- ``RGBDReader.get_depth`` equals the JAX reader's (cv2) exactly.
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from tandem_tpu.pipeline import full_system as jfs
from tandem_tpu_torch.pipeline import full_system as tfs
from tests.test_coarse_tracker import CX, CY, FX, FY, H, W, render_plane
from tests.test_full_system import make_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "replica_traj", "scene0")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this module (six pytest workers share the
    CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _options(pkg):
    return pkg.FullSystemOptions(selection_threshold_factor=0.35,
                                 kf_global_weight=6.0, rgbd=True)


class JaxDvoPoses:
    """The frames of a JAX package FullSystem whose pose is dvo's (the
    port's ``n_dvo_poses``): the frame ran ``dense_match`` and then neither
    ``track_frame`` (dvo's fallback) nor ``track_frame_multi`` (the retry
    ladder). The JAX package keeps no such count, so the three functions
    are wrapped where its FullSystem looks them up."""

    def __init__(self, monkeypatch):
        from tandem_tpu.tracking import coarse_tracker, dvo
        self.calls, self.frames = set(), []
        for mod, name in ((dvo, "dense_match"), (jfs, "track_frame"),
                          (coarse_tracker, "track_frame_multi")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name),
                                                      name))

    def _wrap(self, fn, name):
        def counted(*args, **kw):
            self.calls.add(name)
            return fn(*args, **kw)
        return counted

    def end_frame(self, i, lost):
        if self.calls == {"dense_match"} and not lost:
            self.frames.append(i)
        self.calls.clear()


def _run(pkg, n=10, dvo_poses=None, **kw):
    poses_gt, images = make_sequence(n=n, step=0.02)
    fs = pkg.FullSystem(FX, FY, CX, CY, H, W, options=_options(pkg), **kw)
    for i, (img, pose) in enumerate(zip(images, poses_gt)):
        _, depth = render_plane(pose)
        fs.add_active_frame(img, i, float(i) * 0.1, depth=depth)
        if dvo_poses is not None:
            dvo_poses.end_frame(i, fs.is_lost)
        assert not fs.is_lost, i
    return fs, poses_gt


@pytest.fixture(scope="module")
def port_run():
    return _run(tfs, device="cpu")


def test_rgbd_vo_metric_scale(port_run):
    fs, poses_gt = port_run
    assert fs.initialized
    assert fs.n_dvo_frames == len(poses_gt) - 1
    assert fs.n_dvo_fallbacks == 0
    est = np.stack([p[:3, 3] for p in fs.all_poses])
    gt = np.stack([p[:3, 3] for p in poses_gt])
    err = np.abs(est - gt).max()
    assert err < 0.02, err


def test_rgbd_poses_match_jax(port_run, monkeypatch):
    fs, _ = port_run
    jax_dvo = JaxDvoPoses(monkeypatch)
    jax_fs, _ = _run(jfs, dvo_poses=jax_dvo)
    assert fs.n_dvo_poses == len(jax_dvo.frames) > 0
    a, b = np.stack(jax_fs.all_poses), np.stack(fs.all_poses)
    assert a.shape == b.shape
    assert len(jax_fs.keyframes) == len(fs.keyframes)
    diff = np.abs(a - b).max()
    assert diff < 1e-3, diff


def test_keyframe_without_depth_drops_dvo_ref():
    poses_gt, images = make_sequence(n=4, step=0.02)
    fs = tfs.FullSystem(FX, FY, CX, CY, H, W, options=_options(tfs),
                        device="cpu")
    depths = [render_plane(p)[1] for p in poses_gt]
    fs.add_active_frame(images[0], 0, 0.0, depth=depths[0])
    assert fs._dvo_ref is not None and fs.initialized
    fs.add_active_frame(images[1], 1, 0.1, depth=depths[1])
    assert fs.n_dvo_frames == 1 and len(fs.keyframes) == 2
    assert fs.keyframes[-1].sensor_depth is not None
    # A frame without depth: tracked by track_frame; as a keyframe it has
    # no sensor depth, so the dvo reference goes.
    fs.add_active_frame(images[2], 2, 0.2)
    assert len(fs.keyframes) == 3 and fs.keyframes[-1].sensor_depth is None
    assert fs._dvo_ref is None and fs.n_dvo_frames == 1
    # With depth again but no dvo reference: the track_frame path.
    fs.add_active_frame(images[3], 3, 0.3, depth=depths[3])
    assert fs.n_dvo_frames == 1 and not fs.is_lost
    assert fs._dvo_ref is not None     # that keyframe had depth
    err = np.abs(np.stack([p[:3, 3] for p in fs.all_poses])
                 - np.stack([p[:3, 3] for p in poses_gt])).max()
    assert err < 0.02, err


def test_rgbd_reader_matches_jax():
    from tandem_tpu.data.reader import RGBDReader as JReader
    from tandem_tpu_torch.data.reader import RGBDReader as TReader
    args = (os.path.join(FIXTURE, "images"),)
    kw = dict(depth_path=os.path.join(FIXTURE, "depths"), depth_scale=2e-4)
    j, t = JReader(*args, **kw), TReader(*args, **kw)
    assert len(t) == len(j) == 64 and t.depth_files == j.depth_files
    for i in (0, 31, 63):
        dt = t.get_depth(i)
        assert dt.dtype == np.float32 and dt.shape == (192, 256)
        np.testing.assert_array_equal(dt, j.get_depth(i))
        np.testing.assert_array_equal(t.get_image_bgr(i),
                                      j.get_image_bgr(i))
    # The default scale, 1/5000, is the fixture's own (depths/scale.txt).
    assert TReader(*args, depth_path=kw["depth_path"]).depth_scale == \
        float(open(os.path.join(FIXTURE, "depths", "scale.txt")).read())


def test_tandem_dataset_rgbd_matches_jax(tmp_path):
    from tandem_tpu.cli import tandem_dataset as jcli
    from tandem_tpu_torch.cli import tandem_dataset as tcli
    argv = ["preset=dataset", f"files={os.path.join(FIXTURE, 'images')}",
            f"calib={os.path.join(FIXTURE, 'camera_dso.txt')}", "rgbd=1",
            "end=12"]
    jcli.main(argv + [f"result_folder={tmp_path / 'jax'}"])
    res = tcli.main(argv + [f"result_folder={tmp_path / 'port'}",
                            "device=cpu"])
    assert res["fs"].opt.rgbd and res["fs"].n_dvo_frames == 0

    def rows(side):
        return np.loadtxt(tmp_path / side / "result.txt")
    a, b = rows("jax"), rows("port")
    assert a.shape == b.shape == (12, 8)
    assert np.abs(b[:, 1:4] - b[0, 1:4]).max() > 1e-2, "poses never moved"
    diff = np.abs(a - b).max()
    assert diff < 1e-4, diff


def _replica_rgbd_run(pkg, settings_mod, reader_mod, n=64, dvo_poses=None,
                      **kw):
    """FullSystem(rgbd=True) with the dataset preset over the trajectory
    fixture's frames and sensor depths (scale 0.0002): (ATE dict, frames
    matched, the FullSystem)."""
    from tandem_tpu_torch.eval.ate import (associate, evaluate_ate,
                                           load_tum_trajectory, tum_to_xyz)
    s = settings_mod.parse_arguments(["rgbd=1"],
                                     base=settings_mod.preset("dataset"))
    fs = pkg.FullSystem(200.0, 200.0, 127.5, 95.5, 192, 256,
                        options=pkg.make_full_system_options(s), **kw)
    reader = reader_mod.RGBDReader(os.path.join(FIXTURE, "images"),
                                   depth_path=os.path.join(FIXTURE, "depths"),
                                   depth_scale=2e-4)
    for i in range(n):
        gray, ts, _ = reader.get_image(i)
        fs.add_active_frame(gray, i, ts, bgr=reader.get_image_bgr(i),
                            depth=reader.get_depth(i))
        if dvo_poses is not None:
            dvo_poses.end_frame(i, fs.is_lost)
        if fs.is_lost:
            break
    gt = load_tum_trajectory(os.path.join(FIXTURE, "gt_tum.txt"))
    est = {t: np.concatenate([p[:3, 3], [0, 0, 0, 1]])
           for t, p in zip(fs.all_ts, fs.all_poses)}
    pairs = associate(gt, est)
    ate = evaluate_ate(tum_to_xyz(gt, [a for a, _ in pairs]),
                       tum_to_xyz(est, [b for _, b in pairs]),
                       with_scale=False)
    return ate, len(pairs), fs


@pytest.mark.slow
def test_replica_traj_rgbd_ate(monkeypatch):
    """Slow (~10 min on the CPU, most of it the JAX package's 64 frames):
    the RGB-D ATE on tests/fixtures/replica_traj, SE(3)-aligned without
    scale, of the JAX package and of the port, both on the CPU, and the
    frames whose pose is dvo's in each (printed; run with -s). The port's
    ATE is within 1.5x the JAX package's with >= 56 frames, the bar
    chip_smoke's rgbd phase holds the card to; it holds the card's count
    of dvo poses to the JAX package's printed here."""
    from tandem_tpu import settings as jset
    from tandem_tpu.data import reader as jreader
    from tandem_tpu_torch import settings as tset
    from tandem_tpu_torch.data import reader as treader
    jax_dvo = JaxDvoPoses(monkeypatch)
    ja, jn, jf = _replica_rgbd_run(jfs, jset, jreader, dvo_poses=jax_dvo)
    ta, tn, tf = _replica_rgbd_run(tfs, tset, treader, device="cpu")
    print(f"RGB-D ATE on replica_traj (SE(3), no scale): JAX package "
          f"{ja['rmse'] * 1e3} mm over {jn} frames, port "
          f"{ta['rmse'] * 1e3} mm over {tn} frames; retry ladder JAX "
          f"{jf.n_retracks}, port {tf.n_retracks}; port dvo frames "
          f"{tf.n_dvo_frames}, fallbacks {tf.n_dvo_fallbacks}; frames "
          f"whose pose is dvo's: JAX {len(jax_dvo.frames)} "
          f"{jax_dvo.frames}, port {tf.n_dvo_poses}")
    assert tn >= 56 and ta["rmse"] <= 1.5 * ja["rmse"]
    assert len(jax_dvo.frames) > 0 and tf.n_dvo_poses > 0
