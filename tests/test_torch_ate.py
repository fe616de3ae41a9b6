"""The port's RPE half of ``eval/ate.py`` and its ``tandem_ate`` CLI against
the JAX package's (the same numpy code: equal values unless a tolerance is
stated), and TUM's composition order behind ``tum_order``.

The cases of tests/test_aux.py's RPE tests run through both packages and
must give equal rows and statistics; the mixed rotation + translation case
holds the default to the JAX order and ``tum_order=True`` to values worked
out by hand here (TUM's order: err = inv(rel_gt) rel_est with
rel = inv(T0) T1).
"""

import numpy as np
import pytest

from tandem_tpu.cli import tandem_ate as jcli
from tandem_tpu.eval import ate as jate
from tandem_tpu.pipeline.io import write_result_tum
from tandem_tpu_torch.cli import tandem_ate as tcli
from tandem_tpu_torch.eval import ate as tate


def _traj_line(n, step_t, step_rot=0.0, dt=0.1):
    """{stamp: 4x4} straight-line trajectory: x += step_t, yaw += step_rot
    (tests/test_aux.py's helper)."""
    traj = {}
    for i in range(n):
        c, s = np.cos(step_rot * i), np.sin(step_rot * i)
        T = np.eye(4)
        T[:2, :2] = [[c, -s], [s, c]]
        T[0, 3] = step_t * i
        traj[round(i * dt, 6)] = T
    return traj


CASES = {
    "frames_d1": (lambda: (_traj_line(20, 0.10), _traj_line(20, 0.11)),
                  dict(fixed_delta=True, delta=1, delta_unit="f")),
    "frames_d4": (lambda: (_traj_line(20, 0.10), _traj_line(20, 0.11)),
                  dict(fixed_delta=True, delta=4, delta_unit="f")),
    "rotation_seconds": (lambda: (_traj_line(20, 0.1, step_rot=0.020),
                                  _traj_line(20, 0.1, step_rot=0.025)),
                         dict(fixed_delta=True, delta=0.5, delta_unit="s")),
    "meters": (lambda: (_traj_line(20, 0.10), _traj_line(20, 0.11)),
               dict(fixed_delta=True, delta=0.33, delta_unit="m")),
    "degrees": (lambda: (_traj_line(20, 0.1, step_rot=0.02),
                         _traj_line(20, 0.1, step_rot=0.03)),
                dict(fixed_delta=True, delta=5.0, delta_unit="deg")),
    "all_pairs": (lambda: (_traj_line(6, 0.10), _traj_line(6, 0.11)),
                  dict(max_pairs=10000)),
    "max_pairs": (lambda: (_traj_line(30, 0.1), _traj_line(30, 0.11)),
                  dict(fixed_delta=True, delta=1, delta_unit="f",
                       max_pairs=5)),
    "random_pairs": (lambda: (_traj_line(150, 0.1, step_rot=0.01),
                              _traj_line(150, 0.11, step_rot=0.012)),
                     dict(max_pairs=50)),
    "scale": (lambda: (_traj_line(15, 0.10), _traj_line(15, 0.05)),
              dict(fixed_delta=True, delta=1, delta_unit="f", scale=2.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_rpe_stamped_equals_jax(case):
    make, kw = CASES[case]
    gt, est = make()
    rows_t = tate.evaluate_rpe_stamped(gt, est, **kw)
    rows_j = jate.evaluate_rpe_stamped(gt, est, **kw)
    assert np.array_equal(np.array(rows_t), np.array(rows_j))
    assert tate.rpe_stats(rows_t) == jate.rpe_stats(rows_j)


def test_rpe_cases_of_the_jax_tests():
    """tests/test_aux.py's expected values, on the port."""
    for d in (1, 4):
        rows = tate.evaluate_rpe_stamped(
            _traj_line(20, 0.10), _traj_line(20, 0.11), fixed_delta=True,
            delta=d, delta_unit="f")
        assert len(rows) == 20 - d - 1
        np.testing.assert_allclose([r[4] for r in rows], 0.01 * d,
                                   atol=1e-9)
    rows = tate.evaluate_rpe_stamped(
        _traj_line(20, 0.1, step_rot=0.020),
        _traj_line(20, 0.1, step_rot=0.025), fixed_delta=True, delta=0.5,
        delta_unit="s")
    np.testing.assert_allclose([r[5] for r in rows], 0.025, atol=1e-9)
    assert abs(tate.rpe_stats(rows)["rot_rmse"] - 0.025) < 1e-9
    assert len(tate.evaluate_rpe_stamped(_traj_line(6, 0.10),
                                         _traj_line(6, 0.11))) == 36
    with pytest.raises(ValueError, match="delta unit"):
        tate.evaluate_rpe_stamped(_traj_line(6, 0.1), _traj_line(6, 0.1),
                                  fixed_delta=True, delta_unit="x")


def test_rpe_frames_equals_jax():
    rng = np.random.RandomState(2)
    gt = [np.eye(4) for _ in range(12)]
    est = []
    for i, T in enumerate(gt):
        T[:3, 3] = 0.1 * i
        E = T.copy()
        E[:3, 3] += rng.randn(3) * 0.01
        est.append(E)
    for delta in (1, 3):
        assert (tate.evaluate_rpe(gt, est, delta)
                == jate.evaluate_rpe(gt, est, delta))
    same = tate.evaluate_rpe(gt, [T.copy() for T in gt])
    assert same["trans_rmse"] < 1e-12 and same["rot_rmse"] < 1e-12


def _yaw(theta, t):
    T = np.eye(4)
    c, s = np.cos(theta), np.sin(theta)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = t
    return T


def test_rpe_mixed_rotation_and_translation_orders():
    """gt moves 1 m along x; est moves 1 m along x and turns 90 degrees.
    TUM's order: rel_gt = [I | (1,0,0)], rel_est = [Rz(90) | (1,0,0)],
    err = inv(rel_gt) rel_est = [Rz(90) | 0]: 0 m and pi/2. The JAX
    order: err = rel_est inv(rel_gt) = [Rz(90) | t - Rz t] with
    t = (1, 0, 0): |(1, -1, 0)| = sqrt(2) m, and pi/2."""
    step_gt, step_est = _yaw(0.0, (1.0, 0.0, 0.0)), _yaw(np.pi / 2,
                                                         (1.0, 0.0, 0.0))
    gt, est = {0.0: np.eye(4)}, {0.0: np.eye(4)}
    for i in range(1, 4):
        gt[0.1 * i] = gt[0.1 * (i - 1)] @ step_gt
        est[0.1 * i] = est[0.1 * (i - 1)] @ step_est
    kw = dict(fixed_delta=True, delta=1, delta_unit="f")
    default = tate.evaluate_rpe_stamped(gt, est, **kw)
    assert len(default) == 2
    assert np.array_equal(np.array(default),
                          np.array(jate.evaluate_rpe_stamped(gt, est, **kw)))
    np.testing.assert_allclose([r[4] for r in default], np.sqrt(2.0),
                               atol=1e-12)
    tum = tate.evaluate_rpe_stamped(gt, est, tum_order=True, **kw)
    assert [r[:4] for r in tum] == [r[:4] for r in default]
    np.testing.assert_allclose([r[4] for r in tum], 0.0, atol=1e-12)
    np.testing.assert_allclose([r[5] for r in tum], np.pi / 2, atol=1e-12)
    np.testing.assert_allclose([r[5] for r in default], np.pi / 2,
                               atol=1e-12)


def test_pose44_equals_jax():
    rng = np.random.RandomState(0)
    for _ in range(5):
        vals = rng.randn(7)
        assert np.array_equal(tate._pose44(vals), jate._pose44(vals))
    assert np.array_equal(tate._pose44(np.zeros(7)), np.eye(4))


def _ate_files(tmp_path):
    n = 20
    ts = [i * 0.1 for i in range(n)]
    poses = []
    for i in range(n):
        T = np.eye(4)
        T[:3, 3] = (0.1 * i, 0.05 * i, 0)
        poses.append(T)
    write_result_tum(str(tmp_path / "est.txt"), ts, poses)
    # gt = est scaled by 2 -> rmse ~0 with --scale
    poses_gt = [p.copy() for p in poses]
    for p in poses_gt:
        p[:3, 3] *= 2
    write_result_tum(str(tmp_path / "gt.txt"), ts, poses_gt)
    return ["--est", str(tmp_path / "est.txt"), "--gt",
            str(tmp_path / "gt.txt")]


def test_tandem_ate_cli(tmp_path, capsys):
    """tests/test_cli.py's case on the port's CLI."""
    tcli.main(tcli.parser.parse_args(_ate_files(tmp_path) + ["--scale"]))
    out = capsys.readouterr().out
    rmse = float([ln for ln in out.splitlines()
                  if "rmse" in ln][0].split()[1])
    assert rmse < 1e-6
    scale = float([ln for ln in out.splitlines()
                   if "alignment_scale" in ln][0].split()[1])
    assert abs(scale - 2.0) < 1e-6


@pytest.mark.parametrize("extra", [[], ["--scale"], ["--rpe"]])
def test_tandem_ate_prints_the_jax_lines(tmp_path, capsys, extra):
    args = _ate_files(tmp_path) + extra
    jcli.main(jcli.parser.parse_args(args))
    ref = capsys.readouterr().out
    tcli.main(tcli.parser.parse_args(args))
    assert capsys.readouterr().out == ref
    with pytest.raises(SystemExit):
        tcli.main(tcli.parser.parse_args(
            args + ["--max-difference", "-1"]))
