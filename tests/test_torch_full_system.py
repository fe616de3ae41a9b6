"""The port's FullSystem against the JAX package's on the CPU.

Both run ``tests/test_full_system.py``'s 18-frame textured-plane sequence
(96x128) with that test's options. The port must initialize, make at
least 3 keyframes and stay within 0.03 m of the scale-aligned ground
truth, as the JAX package's own test holds it; against the JAX package it
must initialize on the same frame, make keyframes on the same frame ids,
and keep every pose within 1e-4 (rotation entries and metres: f32 sums in
another order inside the tracker and BA, which the loop feeds back frame
after frame, and the JAX package's drift off SO(3), which the port
repairs; ~6e-6 seen). The result files have the JAX package's line
formats. ``reference_idepth_quantile`` is the same function.
"""

import numpy as np
import pytest
import torch

from tandem_tpu.pipeline import full_system as jfs
from tandem_tpu_torch.pipeline import full_system as tfs
from tests.test_coarse_tracker import CX, CY, FX, FY, H, W
from tests.test_full_system import _align_sim3_translations, make_sequence

OPTS = dict(selection_threshold_factor=0.35, kf_global_weight=6.0,
            ba_iters=4, init_max_width=0.4)
POSE_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this module: the tier-1 run puts six pytest
    workers on the CPU, and torch's default of one thread per core in each
    makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(mod, images, **kw):
    fs = mod.FullSystem(FX, FY, CX, CY, H, W,
                        options=mod.FullSystemOptions(**OPTS), **kw)
    init_frame = None
    for i, img in enumerate(images):
        fs.add_active_frame(img, i, float(i) * 0.1)
        assert not fs.is_lost
        if fs.initialized and init_frame is None:
            init_frame = i
    return fs, init_frame


@pytest.fixture(scope="module")
def runs():
    poses_gt, images = make_sequence(n=18)
    port = _run(tfs, images, device="cpu")
    ref = _run(jfs, images)
    return poses_gt, port, ref


def test_port_tracks_the_sequence(runs):
    poses_gt, (fs, _), _ = runs
    assert fs.initialized
    assert len(fs.keyframes) >= 3
    assert len(fs.all_poses) == len(poses_gt)
    err = _align_sim3_translations([p[:3, 3] for p in fs.all_poses],
                                   [p[:3, 3] for p in poses_gt])
    assert err < 0.03, err


def test_port_matches_jax(runs):
    _, (fs, init_t), (ref, init_j) = runs
    assert init_t == init_j
    assert ([k.frame_id for k in fs.keyframes]
            == [k.frame_id for k in ref.keyframes])
    assert fs.windows == ref.windows
    diff = max(np.abs(a - b).max() for a, b in zip(fs.all_poses,
                                                    ref.all_poses))
    print(f"largest pose difference from the JAX package {diff:.2e}")
    assert diff < POSE_TOL, diff


def test_write_results_formats(runs, tmp_path):
    _, (fs, _), (ref, _) = runs
    fs.write_results(str(tmp_path / "t"))
    ref.write_results(str(tmp_path / "j"))
    for name in ("result.txt", "poses_dso.txt", "keyframes_dso.txt",
                 "dso_optimization_windows.txt"):
        a = (tmp_path / "t" / name).read_text().splitlines()
        b = (tmp_path / "j" / name).read_text().splitlines()
        assert len(a) == len(b) > 0, name
        assert [len(x.split()) for x in a] == [len(x.split()) for x in b]
        if name == "dso_optimization_windows.txt":
            assert a == b
    result = (tmp_path / "t" / "result.txt").read_text().splitlines()
    assert len(result) == len(fs.all_poses)
    assert len(result[0].split()) == 8


def test_tracked_poses_stay_rigid(runs):
    """Every pose the port records keeps an orthonormal rotation (the JAX
    package's drift off SO(3) is repaired in the port)."""
    _, (fs, _), _ = runs
    for c2w in fs.all_poses:
        R = np.asarray(c2w, np.float64)[:3, :3]
        assert np.abs(R.T @ R - np.eye(3)).max() < 1e-5


def test_nearest_rigid():
    """For M = Q (I + E), E symmetric, the nearest rotation is Q: the
    projection returns Q with the translation untouched, and leaves a
    rigid transform as it is (to f32 rounding)."""
    rng = np.random.RandomState(5)
    for _ in range(20):
        Q, _ = np.linalg.qr(rng.randn(3, 3))
        Q *= np.sign(np.linalg.det(Q))
        E = rng.randn(3, 3) * 1e-2
        T = np.eye(4)
        T[:3, :3] = Q @ (np.eye(3) + (E + E.T) / 2)
        T[:3, 3] = rng.randn(3)
        out = tfs._nearest_rigid(T.astype(np.float32))
        assert out.dtype == np.float32
        assert np.abs(out[:3, :3] - Q).max() < 1e-6
        assert np.array_equal(out[:3, 3], T[:3, 3].astype(np.float32))
        rigid = out.copy()
        assert np.abs(tfs._nearest_rigid(rigid) - rigid).max() < 3e-7


def test_reference_idepth_quantile():
    rng = np.random.RandomState(4)
    for n in (1, 2, 7, 100, 1001):
        idv = rng.rand(n).astype(np.float32) * 3
        for frac in (0.0, 0.2, 0.5, 0.99):
            assert (tfs.reference_idepth_quantile(idv, frac)
                    == jfs.reference_idepth_quantile(idv, frac))


def test_not_ported_options_raise():
    for kw in (dict(log_stuff=True),
               dict(debug_save_depth_images=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tfs.FullSystem(FX, FY, CX, CY, H, W,
                           options=tfs.FullSystemOptions(**kw),
                           device="cpu")


def test_default_device_is_the_card():
    """Without a card and without device="cpu" the entry point raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfs.FullSystem(FX, FY, CX, CY, H, W)
