"""The port's host modules against the JAX package's (and OpenCV's where
the JAX package calls it): settings, the CLI's calib and playback helpers,
the image reader, the numpy undistortion, the result writers, the numpy
Rodrigues of the retry ladder, and the ATE evaluation. Everything here is
exact (equal values or equal bytes) unless a tolerance is stated: the
Rodrigues conversions within 1e-9 (float64 formulas in another order) and
the ATE statistics within 1e-12 relative (the same numpy code).
"""

import dataclasses
import os
import zipfile

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from tandem_tpu import settings as jset
from tandem_tpu.cli import tandem_dataset as jcli
from tandem_tpu.data import reader as jreader
from tandem_tpu.data import undistort as jund
from tandem_tpu.eval import ate as jate
from tandem_tpu.pipeline import io as jio
from tandem_tpu_torch import settings as tset
from tandem_tpu_torch.cli import tandem_dataset as tcli
from tandem_tpu_torch.data import reader as treader
from tandem_tpu_torch.data.replica import gray
from tandem_tpu_torch.data import undistort as tund
from tandem_tpu_torch.eval import ate as tate
from tandem_tpu_torch.pipeline import io as tio
from tandem_tpu_torch.pipeline.full_system import (rodrigues_to_matrix,
                                                   rodrigues_to_vector)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ = os.path.join(REPO, "tests", "fixtures", "replica_traj", "scene0")
ADV = os.path.join(REPO, "tests", "fixtures", "adv_traj", "scene0")
RADTAN = ("RadTan 0.52 0.7 0.49 0.51 -0.12 0.04 0.001 -0.0005\n"
          "128 96\ncrop\n120 90\n")


@pytest.mark.parametrize("name", ["dataset", "runtime", "gui", "demo"])
def test_presets_equal_jax(name):
    assert (dataclasses.asdict(tset.preset(name))
            == dataclasses.asdict(jset.preset(name)))


def test_settings_parse_and_strict_keys():
    argv = ["preset=demo", "max_frames=9", "kf_global_weight=2.5",
            "dr_timing=1", "tracking=sparse:cpu", "files=x", "mode=0"]
    assert (dataclasses.asdict(tset.parse_arguments(argv))
            == dataclasses.asdict(jset.parse_arguments(argv)))
    with pytest.raises(KeyError):
        tset.parse_arguments(["bogus_key=1"])
    with pytest.raises(ValueError):
        tset.parse_arguments(["mvsnet_staged=fast"])


def test_read_calib_and_playback_gate(tmp_path):
    path = os.path.join(TRAJ, "camera_dso.txt")
    assert tcli.read_calib(path) == jcli.read_calib(path)
    radtan = tmp_path / "radtan.txt"
    radtan.write_text(RADTAN)
    assert tcli.read_calib(str(radtan)) == jcli.read_calib(str(radtan))
    for target, since, parity in ((1.0, 0.5, 0), (1.0, 1.2, 0),
                                  (1.0, 1.55, 0), (1.0, 1.55, 1),
                                  (0.0, 3.0, 3)):
        assert (tcli.playback_gate(target, since, parity)
                == jcli.playback_gate(target, since, parity))


def test_undistort_numpy_matches_jax(tmp_path, monkeypatch):
    radtan = tmp_path / "radtan.txt"
    radtan.write_text(RADTAN)
    a = tund.Undistort.from_file(str(radtan))
    b = jund.Undistort.from_file(str(radtan))
    assert np.array_equal(a.K, b.K)
    assert np.array_equal(a.remap_x, b.remap_x)
    assert np.array_equal(a.remap_y, b.remap_y)
    monkeypatch.setattr(jund, "cv2", None)       # the JAX numpy path
    rng = np.random.RandomState(0)
    for shape in ((96, 128), (96, 128, 3)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        assert np.array_equal(a.undistort_image(img), b.undistort_image(img))


def test_gray_equals_cv2():
    """``data/replica.gray`` is OpenCV's BGR -> grey of the installed
    OpenCV (the JAX reader's), on every (b, g) pair for a sweep of r."""
    b, g = np.meshgrid(np.arange(256), np.arange(256))
    for r in range(0, 256, 5):
        bgr = np.stack([b, g, np.full_like(b, r)], -1).astype(np.uint8)
        assert np.array_equal(gray(bgr), cv2.cvtColor(bgr,
                                                      cv2.COLOR_BGR2GRAY))


def _reader_pair(path, **kw):
    return treader.ImageFolderReader(path, **kw), jreader.ImageFolderReader(
        path, **kw)


def _same_frames(a, b, idx):
    for i in idx:
        ga, ta, ea = a.get_image(i)
        gb, tb, eb = b.get_image(i)
        assert ga.dtype == gb.dtype and np.array_equal(ga, gb), i
        assert (ta, ea) == (tb, eb)
        assert np.array_equal(a.get_image_bgr(i), b.get_image_bgr(i))


def test_reader_matches_jax_on_the_trajectory_fixture():
    a, b = _reader_pair(os.path.join(TRAJ, "images"))
    assert a.files == b.files and len(a) == 64
    assert a.timestamps == b.timestamps
    _same_frames(a, b, (0, 17, 63))
    assert a.get_image(5)[0].dtype == np.uint8


def test_reader_gamma_vignette_matches_jax():
    kw = dict(gamma=os.path.join(ADV, "pcalib.txt"),
              vignette=os.path.join(ADV, "vignette.png"))
    a, b = _reader_pair(os.path.join(ADV, "images"), **kw)
    assert a.timestamps == b.timestamps and a.exposures == b.exposures
    _same_frames(a, b, (0, 101))
    assert a.get_image(0)[0].dtype == np.float32


def test_reader_zip_matches_jax(tmp_path):
    zpath = tmp_path / "images.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for i in (3, 1, 2):
            name = f"{i:06d}.png"
            z.write(os.path.join(TRAJ, "images", name), name)
    a, b = _reader_pair(str(zpath))
    assert a.files == b.files
    _same_frames(a, b, range(3))


def test_reader_rejects_other_formats(tmp_path):
    cv2.imwrite(str(tmp_path / "000000.jpg"), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="PNG"):
        treader.ImageFolderReader(str(tmp_path)).get_image(0)


def test_vignette_of_another_size_raises(tmp_path):
    cv2.imwrite(str(tmp_path / "v.png"), np.full((10, 12), 200, np.uint8))
    und = tund.PhotometricUndistorter(None, str(tmp_path / "v.png"))
    with pytest.raises(ValueError, match="vignette"):
        und.process(np.zeros((20, 24), np.uint8))
    with pytest.raises(ValueError, match="vignette"):
        tund.PhotometricUndistorter(None, str(tmp_path / "v.png"), (24, 20))


def test_writers_byte_equal(tmp_path):
    rng = np.random.RandomState(0)
    poses = []
    for k in range(6):
        R = cv2.Rodrigues(rng.randn(3) * (0.5 + k))[0]
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, rng.randn(3)
        poses.append(T)
    ts = list(np.arange(6) / 30.0)
    windows = [[0, 3, 5], [3, 5, 8, 9]]
    for mod, tag in ((tio, "t"), (jio, "j")):
        mod.write_result_tum(str(tmp_path / f"{tag}_r.txt"), ts, poses)
        mod.write_poses_mat(str(tmp_path / f"{tag}_p.txt"), range(6), poses)
        mod.write_optimization_windows(str(tmp_path / f"{tag}_w.txt"),
                                       windows, [1.0, 0.5])
    for f in ("r", "p", "w"):
        assert ((tmp_path / f"t_{f}.txt").read_bytes()
                == (tmp_path / f"j_{f}.txt").read_bytes())


def _rotations():
    rng = np.random.RandomState(1)
    vecs = [np.zeros(3), np.array([1e-9, 0, 0]), np.array([0, 2e-6, 1e-6])]
    for _ in range(20):
        axis = rng.randn(3)
        axis /= np.linalg.norm(axis)
        for angle in (1e-4, 0.3, 2.0, np.pi - 1e-7, np.pi - 1e-3, np.pi):
            vecs.append(axis * angle)
    vecs.append(np.array([np.pi, 0, 0]))
    vecs.append(np.array([0, 0, -np.pi]))
    return vecs


def test_rodrigues_matches_cv2():
    for v in _rotations():
        R = cv2.Rodrigues(v)[0]
        assert np.abs(rodrigues_to_matrix(v) - R).max() < 1e-9, v
        got = rodrigues_to_vector(R)
        want = cv2.Rodrigues(R)[0][:, 0]
        # At exactly pi, v and -v are the same rotation.
        if np.linalg.norm(want) > np.pi - 1e-6:
            assert (np.abs(got - want).max() < 1e-6
                    or np.abs(got + want).max() < 1e-6), v
        else:
            assert np.abs(got - want).max() < 1e-9, v


def test_ate_matches_jax(tmp_path):
    rng = np.random.RandomState(2)
    gt = {i / 30.0: np.r_[rng.randn(3), 0, 0, 0, 1] for i in range(40)}
    est = {i / 30.0 + 0.001: np.r_[2.0 * gt[i / 30.0][:3] + 0.01
                                   * rng.randn(3), 0, 0, 0, 1]
           for i in range(3, 40)}
    ma, mb = tate.associate(gt, est), jate.associate(gt, est)
    assert ma == mb and len(ma) == 37
    g = tate.tum_to_xyz(gt, [a for a, _ in ma])
    e = tate.tum_to_xyz(est, [b for _, b in ma])
    for scale in (False, True):
        sa = tate.evaluate_ate(g, e, with_scale=scale)
        sb = jate.evaluate_ate(g, e, with_scale=scale)
        for k in sb:
            assert abs(sa[k] - sb[k]) <= 1e-12 * max(abs(sb[k]), 1.0), k
    path = os.path.join(TRAJ, "gt_tum.txt")
    la, lb = tate.load_tum_trajectory(path), jate.load_tum_trajectory(path)
    assert la.keys() == lb.keys()
    assert all(np.array_equal(la[k], lb[k]) for k in la)
