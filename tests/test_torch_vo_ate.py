"""End-to-end trajectory gate of the port on the CPU: ATE on the committed
fixture, the two runs of tests/test_vo_ate.py through the port's
tandem_dataset CLI (``device=cpu``) on tests/fixtures/replica_traj (64
frames, 256x192): monocular VO only, and the full pipeline with the
trained abl04 unit (bf16 MVSNet -> TSDF -> rendered-depth dense tracking)
with a non-empty mesh. Result.txt is Sim3-aligned to the GT poses; the
bars are tests/test_vo_ate.py's (>= 56 frames, ATE < 30 mm).

The port keeps each tracked pose rigid; the JAX package does not, and its
trajectory on this fixture then depends on changes of fx far below any
calibration's accuracy. The last two tests measure both.
"""

import os

import numpy as np
import pytest

from tandem_tpu_torch.cli import tandem_dataset
from tandem_tpu_torch.eval.ate import (associate, evaluate_ate,
                                       load_tum_trajectory, tum_to_xyz)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "replica_traj", "scene0")
EXPORTED = os.path.join(REPO, "exported", "tandem")


def _run(out_dir: str, mvsnet: bool) -> dict:
    argv = ["preset=dataset", f"files={os.path.join(FIXTURE, 'images')}",
            f"calib={os.path.join(FIXTURE, 'camera_dso.txt')}",
            f"result_folder={out_dir}", "device=cpu"]
    if mvsnet:
        argv.append(f"mvsnet_folder={EXPORTED}")
    tandem_dataset.main(argv)
    gt = load_tum_trajectory(os.path.join(FIXTURE, "gt_tum.txt"))
    est = load_tum_trajectory(os.path.join(out_dir, "result.txt"))
    matches = associate(gt, est)
    assert len(matches) >= 56, f"only {len(matches)}/64 frames tracked"
    return evaluate_ate(tum_to_xyz(gt, [a for a, _ in matches]),
                        tum_to_xyz(est, [b for _, b in matches]),
                        with_scale=True)


@pytest.mark.slow
def test_port_vo_only_ate(tmp_path):
    stats = _run(str(tmp_path), mvsnet=False)
    print(f"port VO-only ATE rmse {stats['rmse'] * 1000:.1f} mm")
    assert stats["rmse"] < 0.030, f"ATE rmse {stats['rmse']:.4f} m"


@pytest.mark.slow
def test_port_full_pipeline_ate_and_mesh(tmp_path):
    stats = _run(str(tmp_path), mvsnet=True)
    print(f"port full-pipeline ATE rmse {stats['rmse'] * 1000:.1f} mm")
    assert stats["rmse"] < 0.030, f"ATE rmse {stats['rmse']:.4f} m"
    verts = [ln for ln in open(tmp_path / "mesh.obj") if ln.startswith("v ")]
    faces = [ln for ln in open(tmp_path / "mesh.obj") if ln.startswith("f ")]
    assert len(verts) > 1000 and len(faces) > 1000
    xyz = np.array([[float(x) for x in ln.split()[1:4]] for ln in verts])
    assert np.isfinite(xyz).all() and xyz.std(axis=0).max() > 0.1


def _rigid_record_pose(jm):
    """The JAX FullSystem's _record_pose with each pose's rotation first
    moved to the nearest rotation, as the port keeps its tracked poses."""
    from tandem_tpu_torch.pipeline.full_system import _nearest_rigid
    orig = jm.FullSystem._record_pose

    def record_pose(self, frame_id, timestamp, c2w):
        return orig(self, frame_id, timestamp, _nearest_rigid(c2w))
    return record_pose


@pytest.mark.slow
@pytest.mark.parametrize("package", ["jax", "jax with rigid poses", "port"])
def test_ate_under_tiny_fx_changes(tmp_path, monkeypatch, package):
    """VO only at fx 200 and at fx changed by 5e-7 and 5e-6 of itself,
    through the port's probe (tandem_tpu_torch/experiments/
    ate_sensitivity.py): prints each ATE and keyframe count. Every run
    tracks >= 56 frames. The JAX package as it is lands anywhere between
    ~7 and ~34 mm (measured, not bounded); with its tracked poses kept
    rigid, and the port, every run is under the 30 mm bar and the four
    ATEs lie within 1 mm of each other."""
    import functools

    import tests.conftest  # noqa: F401  (JAX on the CPU)
    from tandem_tpu.cli import tandem_dataset as jcli
    from tandem_tpu.pipeline import full_system as jm
    from tandem_tpu_torch.experiments.ate_sensitivity import sweep
    main = jcli.main
    if package == "jax with rigid poses":
        monkeypatch.setattr(jm.FullSystem, "_record_pose",
                            _rigid_record_pose(jm))
    elif package == "port":
        main = functools.partial(tandem_dataset.main, device="cpu")
    rows = sweep(main, tmp_path)
    for row in rows:
        print(f"{package}: {row}")
    assert all(row["frames"] >= 56 for row in rows)
    if package != "jax":
        ates = [row["ate_mm"] for row in rows]
        assert max(ates) < 30.0 and max(ates) - min(ates) < 1.0, ates


@pytest.mark.slow
def test_lockstep_with_the_jax_package():
    """The port's FullSystem beside the JAX package's on the fixture's
    first 24 frames (VO only, fx 200): per frame the largest departure of
    each tracked rotation from SO(3), |R^T R - I|, and the largest pose
    difference, printed. The port's rotations stay rigid to 1e-5; the JAX
    package's departure grows about 2.4x a frame with alternating sign
    (its motion model inverts in general, its tracked pose rigidly), so
    the two agree within 1e-5 only while that departure is small, through
    frame 12."""
    import tests.conftest  # noqa: F401  (JAX on the CPU)
    import tandem_tpu.pipeline.full_system as jm
    import tandem_tpu_torch.pipeline.full_system as tm
    from tandem_tpu.settings import preset as jpreset
    from tandem_tpu_torch.data.replica import gray, read_png
    from tandem_tpu_torch.settings import preset as tpreset
    size = (200.0, 200.0, 127.5, 95.5, 192, 256)
    jax_fs = jm.FullSystem(*size, options=jm.make_full_system_options(
        jpreset("dataset")))
    port_fs = tm.FullSystem(*size, options=tm.make_full_system_options(
        tpreset("dataset")), device="cpu")

    def departure(c2w):
        R = np.asarray(c2w, np.float64)[:3, :3]
        return float(np.abs(R.T @ R - np.eye(3)).max())
    for i in range(24):
        img = gray(read_png(os.path.join(FIXTURE, "images",
                                         f"{i:06d}.png"))[..., ::-1])
        jax_fs.add_active_frame(img, i, i / 30)
        port_fs.add_active_frame(img, i, i / 30)
        a, b = jax_fs.all_poses[-1], port_fs.all_poses[-1]
        diff = float(np.abs(a - b).max())
        print(f"frame {i}: |R^T R - I| JAX {departure(a):.2e} port "
              f"{departure(b):.2e}; pose difference {diff:.2e}; keyframes "
              f"{len(jax_fs.keyframes)} / {len(port_fs.keyframes)}")
        assert departure(b) < 1e-5, i
        if i <= 12:
            assert diff < 1e-5, (i, diff)
