"""The port's debug observability (``utils/dso_log.py`` wired into
FullSystem: ``log_stuff`` and ``debug_save_depth_images``) against the JAX
package's on the same drive: tests/test_dso_log.py's 16-frame textured-plane
sequence with its options, through both packages.

The checks of tests/test_dso_log.py hold on the port, and against the JAX
package the files have the same names, the same line counts and the same
number of columns on every line; the depth dumps have the same names and
both decode to uint16 (H, W) maps whose largest value decodes back to the
largest depth (the scale contract). The values are the tracker's and BA's,
which agree with the JAX package's within the pose tolerance of
tests/test_torch_full_system.py; they are not compared here.
"""

import os

import numpy as np
import pytest
import torch

from tandem_tpu.pipeline import full_system as jfs
from tandem_tpu_torch.data.replica import read_png
from tandem_tpu_torch.pipeline import full_system as tfs
from tandem_tpu_torch.utils.dso_log import _fmt, save_depth_png
from tests.test_coarse_tracker import CX, CY, FX, FY, H, W
from tests.test_full_system import make_sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this module: the tier-1 run puts six pytest
    workers on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _drive(mod, root, **kw):
    _, images = make_sequence(n=16)
    opts = mod.FullSystemOptions(
        selection_threshold_factor=0.35, kf_global_weight=6.0, ba_iters=4,
        init_max_width=0.4, log_stuff=True, log_dir=str(root / "logs"),
        debug_save_depth_images=True,
        depth_save_folder=str(root / "depths"))
    fs = mod.FullSystem(FX, FY, CX, CY, H, W, options=opts, **kw)
    for i, img in enumerate(images):
        fs.add_active_frame(img, i, float(i) * 0.1)
        assert not fs.is_lost
    fs.write_results(str(root / "out"))
    return fs


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    port_root = tmp_path_factory.mktemp("port")
    jax_root = tmp_path_factory.mktemp("jax")
    return ((_drive(tfs, port_root, device="cpu"), port_root),
            (_drive(jfs, jax_root), jax_root))


def test_log_stuff_files(drives):
    """tests/test_dso_log.py:33 on the port."""
    (fs, root), _ = drives
    d = root / "logs"
    n_kf = len(fs.keyframes)
    assert n_kf >= 2
    nums = (d / "numsLog.txt").read_text().strip().splitlines()
    assert len(nums) == n_kf - 1          # the init KF pair logs once
    cols = nums[-1].split()
    assert len(cols) == 17
    assert int(cols[16]) >= 2             # window size
    assert int(cols[2]) > 0               # created points accumulate
    nz = max(100, fs.opt.max_keyframes * 10)
    for name in ("eigenAllLog.txt", "eigenPLog.txt", "eigenALog.txt",
                 "diagonal.txt", "variancesLog.txt"):
        lines = (d / name).read_text().strip().splitlines()
        assert len(lines) == n_kf - 1, name
        assert len(lines[-1].split()) == 1 + nz, name
    eig = np.array([float(v) for v in (d / "eigenAllLog.txt").read_text()
                    .strip().splitlines()[-1].split()[1:]])
    live = eig[eig != 0.0]
    assert np.all(np.diff(live) >= -1e-6 * np.abs(live[:-1]))  # sorted
    ns_line = (d / "nullspacesLog.txt").read_text().strip() \
        .splitlines()[-1].split()
    assert len(ns_line) == 1 + 2 * 9
    forms = np.abs(np.array([float(v) for v in ns_line[1::2]]))
    assert np.all(np.isfinite(forms))
    assert np.all(forms <= 1e-2 * np.abs(live).max() + 10.0)
    ct = (d / "coarseTrackingLog.txt").read_text().strip().splitlines()
    assert len(ct) >= 3 and len(ct[-1].split()) == 13
    lt = (d / "lifetimeLog.txt").read_text().strip().splitlines()
    assert len(lt) == len(fs.all_poses)
    assert all(len(ln.split()) == 5 for ln in lt)


def test_logs_match_the_jax_package(drives):
    (_, port), (_, ref) = drives
    names = sorted(os.listdir(ref / "logs"))
    assert sorted(os.listdir(port / "logs")) == names and len(names) == 10
    for name in names:
        a = (port / "logs" / name).read_text().splitlines()
        b = (ref / "logs" / name).read_text().splitlines()
        assert len(a) == len(b), name
        assert [len(x.split()) for x in a] == [len(x.split()) for x in b], \
            name
        # the same frame ids in the first column
        assert [x.split()[:1] for x in a] == [x.split()[:1] for x in b], name


def test_depth_dumps(drives):
    """tests/test_dso_log.py:85 on the port, and the JAX package's file
    names."""
    (fs, port), (_, ref) = drives
    folder = port / "depths"
    pngs = sorted(p for p in os.listdir(folder) if p.endswith(".png"))
    assert len(pngs) >= len(fs.keyframes) - 1
    assert sorted(os.listdir(folder)) == sorted(os.listdir(ref / "depths"))
    img = read_png(folder / pngs[-1])
    assert img.dtype == np.uint16 and img.shape == (H, W)
    scale = float((folder / pngs[-1].replace(".png", "_scale.txt"))
                  .read_text())
    depth = img.astype(np.float64) * scale
    pos = depth[img > 0]
    assert len(pos) > 0
    assert abs(pos.max() - 65535 * scale) < 2 * scale


def test_save_depth_png_equals_the_jax_writer(tmp_path):
    """The same bytes of depth as cv2.imwrite + the same sidecar."""
    cv2 = pytest.importorskip("cv2")
    from tandem_tpu.utils.dso_log import save_depth_png as jsave
    rng = np.random.RandomState(0)
    idepth = rng.rand(24, 32).astype(np.float32) * 2
    weight = (rng.rand(24, 32) > 0.3).astype(np.float32)
    save_depth_png(str(tmp_path / "t"), 7, idepth, weight)
    jsave(str(tmp_path / "j"), 7, idepth, weight)
    a = read_png(tmp_path / "t" / "000007.png")
    b = cv2.imread(str(tmp_path / "j" / "000007.png"), cv2.IMREAD_UNCHANGED)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ((tmp_path / "t" / "000007_scale.txt").read_text()
            == (tmp_path / "j" / "000007_scale.txt").read_text())
    assert _fmt([1.0, 1e-12, 123456789.123]) == "1 1e-12 123456789.1"
