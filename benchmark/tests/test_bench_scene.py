"""The scene and the path: deterministic from the seed, exact ground truth,
the path's step sizes and period, and the grey conversion."""

import math

import numpy as np
import pytest
import torch

from benchmark.traffic import scene

PATH = {"period": 300, "x_radius": 0.45, "z_radius": 0.2, "z": -0.3,
        "y": -0.1, "bob": 0.02, "yaw": 0.15, "yaw_wobble": 0.02,
        "pitch": 0.11, "pitch_wobble": 0.02, "roll_wobble": 0.01}
CAM = scene.Camera(64, 48, 37.5, 37.5)


def test_same_seed_same_frames():
    a = scene.render_frames([0, 7], PATH, CAM, scene.texture_offset(11),
                            "cpu")
    b = scene.render_frames([0, 7], PATH, CAM, scene.texture_offset(11),
                            "cpu")
    assert (a[0] == b[0]).all() and (a[1] == b[1]).all()
    assert torch.equal(a[2], b[2])


def test_seed_moves_the_decor_not_the_geometry():
    big = 2 ** 31 + 12345          # seeds larger than 32 signed bits
    a = scene.render_frames([3], PATH, CAM, scene.texture_offset(big), "cpu")
    b = scene.render_frames([3], PATH, CAM, scene.texture_offset(big + 1),
                            "cpu")
    assert (a[0] != b[0]).mean() > 0.2
    assert torch.equal(a[2], b[2])


def test_depth_is_exact():
    """The centre ray from (-0.2, -0.5, 0.5) along +z meets the angled
    wall -0.45 x + z = 2.2 at z = 2.11 (before the back wall at 3.2): its
    z-depth is 1.61 m. Turned down 90 degrees it meets the floor (y = 0.9)
    1.4 m away."""
    c2w = np.eye(4)
    c2w[:3, 3] = (-0.2, -0.5, 0.5)
    cam = scene.Camera(17, 13, 8.0, 8.0)
    _, _, depth = scene.render(c2w, cam, device="cpu")
    assert float(depth[6, 8]) == pytest.approx(1.61, abs=1e-6)
    c2w[:3, :3] = scene.rotation(0.0, -math.pi / 2, 0.0)
    _, _, depth = scene.render(c2w, cam, device="cpu")
    assert float(depth[6, 8]) == pytest.approx(1.4, abs=1e-6)


def test_path_steps_and_period():
    dt, dr = scene.path_step(PATH)
    assert 0.005 < dt < 0.012            # about 1 cm a frame
    assert dr < 0.5                      # under half a degree a frame
    assert np.allclose(scene.path_pose(0, PATH), scene.path_pose(300, PATH))
    R = scene.path_pose(17, PATH)[:3, :3]
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-12)


def test_grey_is_opencv5_fixed_point():
    rng = np.random.default_rng(0)
    bgr = torch.from_numpy(rng.integers(0, 256, (50, 3), dtype=np.uint8))
    b, g, r = (bgr[:, i].numpy().astype(np.int64) for i in range(3))
    want = (3735 * b + 19235 * g + 9798 * r + 16384) >> 15
    assert scene.grey(bgr).numpy().tolist() == want.tolist()


def test_renders_on_the_device_it_is_given():
    _, _, depth = scene.render_frames([0], PATH, CAM, (0.0, 0.0, 0.0),
                                      "cpu")
    assert depth.device.type == "cpu" and depth.dtype == torch.float32
    assert float(depth.min()) > 1.0 and math.isfinite(float(depth.max()))
