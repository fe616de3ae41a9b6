"""The port's tandem_dataset CLI on the CPU (``device=cpu``), headless.

A 22-frame 96x128 sequence of the textured plane is written as PNGs; the
CLI runs it VO-only and with a unit that holds only the trained weights
and their model_config.json (no golden pack, so no boot self-check: the
JAX CLI skips it the same way, and the shipped pack is a 640x480 forward).
result.txt must have one line per frame with moving poses, and mesh.obj
must exist with a unit. ``verify_golden`` replays
``exported/tandem_512x320``'s pack in f32 on the CPU within the
reference's boot bar (GOLDEN_TOL = 1e-2 worst MAE). The argument chain is
strict; log_stuff, debug_save_depth_images, save_dr_video and viewer3d
write their outputs, preload=1 gives the default route's result.txt, and
a model.stablehlo-only unit raises.
"""

import os
import shutil

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from tandem_tpu_torch.cli import tandem_dataset
from tandem_tpu_torch.cli.golden import GOLDEN_TOL, verify_golden
from tandem_tpu_torch.models.convert import load_variables
from tests.test_coarse_tracker import CX, CY, FX, FY, H, W
from tests.test_full_system import make_sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIT = os.path.join(REPO, "exported", "tandem")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this module: the tier-1 run puts six pytest
    workers on the CPU, and torch's default of one thread per core in each
    makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq")
    img_dir = root / "images"
    img_dir.mkdir()
    _, images = make_sequence(n=22, step=0.02)
    for i, img in enumerate(images):
        cv2.imwrite(str(img_dir / f"{i:06d}.png"),
                    np.stack([img] * 3, -1).astype(np.uint8))
    calib = root / "camera.txt"
    calib.write_text(f"Pinhole {FX} {FY} {CX} {CY} 0\n{W} {H}\n")
    return img_dir, calib


def _argv(sequence, out, *extra):
    img_dir, calib = sequence
    # A keyframe every few frames on this short sequence; a small window
    # (F = 5 slots, 256 point and 256 immature slots) keeps BA cheap.
    return [f"files={img_dir}", f"calib={calib}", f"result_folder={out}",
            "kf_global_weight=6", "max_frames=4", "desired_point_density=256",
            "desired_immature_density=256", *extra]


def _check_result(out, n):
    lines = (out / "result.txt").read_text().splitlines()
    assert len(lines) == n
    xyz = np.array([[float(v) for v in ln.split()[1:4]] for ln in lines])
    assert np.isfinite(xyz).all()
    assert np.abs(xyz - xyz[0]).max() > 1e-3, "poses never moved"


def test_cli_vo_only(sequence, tmp_path):
    out = tmp_path / "out"
    res = tandem_dataset.main(_argv(sequence, out, "dr_timing=1", "end=12",
                                    "device=cpu"))
    assert res["frames"] == 12 and res["backend"] is None
    _check_result(out, 12)
    for name in ("poses_dso.txt", "keyframes_dso.txt",
                 "dso_optimization_windows.txt", "dr_times.txt"):
        assert (out / name).exists(), name
    assert not (out / "mesh.obj").exists()


def test_cli_with_a_unit(sequence, tmp_path):
    unit = _unit(tmp_path)
    out = tmp_path / "out"
    res = tandem_dataset.main(_argv(sequence, out, f"mvsnet_folder={unit}",
                                    "mesh_extraction_freq=2",
                                    "dr_mvsnet_view_num=3"), device="cpu")
    _check_result(out, 22)
    assert res["backend"] is not None
    assert (out / "mesh.obj").exists()


@pytest.mark.slow
def test_verify_golden_512x320():
    """Slow: a 512x320 forward in f32 takes 13 s on the CPU."""
    unit = os.path.join(REPO, "exported", "tandem_512x320")
    err = verify_golden(os.path.join(unit, "sample_inputs.npz"),
                        load_variables(os.path.join(unit,
                                                    "model_variables.pkl")),
                        "cpu")
    assert err < GOLDEN_TOL, err


def test_strict_arguments(sequence, tmp_path):
    with pytest.raises(KeyError):
        tandem_dataset.main(_argv(sequence, tmp_path, "bogus_key=1",
                                  "device=cpu"))
    with pytest.raises(AssertionError, match="files="):
        tandem_dataset.main([f"calib={sequence[1]}", "device=cpu"])


def _unit(tmp_path):
    unit = tmp_path / "unit"
    unit.mkdir()
    for name in ("model_variables.pkl", "model_config.json"):
        shutil.copy(os.path.join(UNIT, name), unit / name)
    return unit


@pytest.mark.parametrize("flag", ["log_stuff=1", "viewer3d=1",
                                  "save_dr_video=1", "preload=1",
                                  "debug_save_depth_images=1"])
def test_options_not_ported_raise(sequence, tmp_path, flag):
    """The options that raised before this port carried them now run and
    write their outputs (save_dr_video's panels need a unit)."""
    out = tmp_path / "out"
    extra = (["end=12"] if flag != "save_dr_video=1" else
             [f"mvsnet_folder={_unit(tmp_path)}", "mesh_extraction_freq=2",
              "dr_mvsnet_view_num=3"])
    res = tandem_dataset.main(_argv(sequence, out, flag, "device=cpu",
                                    *extra))
    n = res["frames"]
    _check_result(out, n)
    written = {"log_stuff=1": out / "logs",
               "debug_save_depth_images=1": out / "depths",
               "save_dr_video=1": out / "dr_video",
               "viewer3d=1": out / "view3d"}
    if flag in written:
        assert written[flag].is_dir()
    if flag == "viewer3d=1":
        assert (out / "view3d_final.png").stat().st_size > 1000
    elif flag == "preload=1":
        base = tmp_path / "base"
        tandem_dataset.main(_argv(sequence, base, "device=cpu", "end=12"))
        assert ((base / "result.txt").read_bytes()
                == (out / "result.txt").read_bytes())
    else:
        assert len(os.listdir(written[flag])) > 0, flag


def test_stablehlo_only_unit_raises(sequence, tmp_path):
    unit = tmp_path / "unit"
    unit.mkdir()
    (unit / "model.stablehlo").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="stablehlo"):
        tandem_dataset.main(_argv(sequence, tmp_path,
                                  f"mvsnet_folder={unit}"), device="cpu")
