"""The port's headless 3D viewer (``pipeline/viewer.py``) and output sinks
(``pipeline/output_wrapper.py``) against the JAX package's.

The six cases of tests/test_viewer.py run on the port. Against the JAX
viewer on the same scene state (trajectory, keyframes, a point cloud and a
shaded mesh): the projections of the trajectory vertices, the frustum
corners and the point cloud's pixels are equal exactly, the point cloud
and its colours are equal exactly, and the renders differ only where the
port's solid lines and triangle fill replace OpenCV's anti-aliased lines
and cv2.fillConvexPoly: at most RENDER_ANY of the pixels differ at all,
and at most RENDER_FAR by more than 40 in a channel (measured on the
scene below: 10.6% and 0.25%).
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from tandem_tpu.pipeline import output_wrapper as jout
from tandem_tpu.pipeline.viewer import Viewer3DWrapper as JViewer
from tandem_tpu_torch.data.replica import read_png
from tandem_tpu_torch.pipeline import output_wrapper as tout
from tandem_tpu_torch.pipeline.viewer import (Viewer3DWrapper,
                                              draw_segments, fill_triangles)

RENDER_ANY = 0.15
RENDER_FAR = 0.01


class _KF:
    def __init__(self, c2w):
        self.c2w = c2w


def make_viewer(**kw):
    kw.setdefault("size", (320, 240))
    return Viewer3DWrapper(**kw)


def test_render_empty_scene():
    img = make_viewer().render()
    assert img.shape == (240, 320, 3) and img.dtype == np.uint8
    assert (img > 30).any()          # the ground grid


def test_trajectory_projects_to_pixels():
    def viewer():
        v = make_viewer()
        v.show_mesh = v.show_points = v.show_kfs = False
        v.follow = False
        v.cam.target = np.zeros(3)
        return v
    v, base = viewer(), viewer()
    for i in range(10):
        c2w = np.eye(4)
        c2w[:3, 3] = [0.1 * i - 0.5, 0.0, 0.0]
        v.publish_cam_pose(i, c2w)
    img, empty = v.render(), base.render()
    diff = (img.astype(int) - empty.astype(int)).sum(-1)
    ys, xs = np.nonzero(np.abs(diff) > 30)
    assert len(xs) > 20
    assert abs(xs.mean() - 160) < 80 and abs(ys.mean() - 120) < 80
    ch = img[ys, xs].astype(int)
    assert ch[:, 1].mean() > ch[:, 0].mean()
    assert ch[:, 1].mean() > ch[:, 2].mean()


def test_keyframe_frusta_and_toggle():
    v = make_viewer()
    v.show_mesh = v.show_points = v.show_trajectory = False
    v.follow = False
    v.publish_keyframes([_KF(np.eye(4))])
    with_kf = v.render().copy()
    v.show_kfs = False
    assert (with_kf != v.render()).any()


def test_depth_backprojection_point_cloud():
    v = make_viewer(K=(100.0, 100.0, 63.5, 47.5))
    v.publish_keyframes([_KF(np.eye(4))])
    depth = np.full((96, 128), 2.0, np.float32)
    v.push_dr_kf_depth(depth, np.ones_like(depth))
    assert v.points is not None and len(v.points) > 500
    np.testing.assert_allclose(v.points[:, 2], 2.0, atol=1e-5)
    assert v.point_colors.shape == v.points.shape


def test_mesh_render_and_record(tmp_path):
    out = str(tmp_path / "rec")
    v = make_viewer(out_dir=out)
    v.follow = False
    verts = np.array([[-1, -1, 3], [1, -1, 3], [0, 1, 3]], np.float32)
    v.push_dr_mesh(verts, np.array([[0, 1, 2]], np.int64))
    img = v.render()
    assert (img.mean(-1) > 60).sum() > 500
    rec = read_png(os.path.join(out, "view3d_000000.png"))
    assert np.array_equal(rec[..., ::-1], img)   # an RGB file of the BGR


def test_snapshot(tmp_path):
    v = make_viewer()
    p = str(tmp_path / "snap.png")
    v.snapshot(p)
    assert np.array_equal(cv2.imread(p), v.render())


def test_interactive_window_raises():
    with pytest.raises(NotImplementedError, match="HighGUI"):
        Viewer3DWrapper(interactive=True)


def _scene(v):
    rng = np.random.RandomState(0)
    for i in range(20):
        c = np.eye(4)
        c[:3, 3] = [0.05 * i - 0.5, 0.02 * np.sin(i), 0.03 * i]
        v.publish_cam_pose(i, c)
    v.publish_keyframes([_KF(np.eye(4)), _KF(c)])
    d = 2.0 + rng.rand(96, 128).astype(np.float32) * 0.1
    v.push_dr_kf_depth(d, np.ones_like(d))
    xs, ys = np.meshgrid(np.linspace(-1, 1, 30), np.linspace(-1, 1, 30))
    verts = np.stack([xs.ravel(), ys.ravel(),
                      3 + 0.2 * np.sin(3 * xs.ravel())], -1)
    faces = []
    for r in range(29):
        for c_ in range(29):
            a = r * 30 + c_
            faces += [[a, a + 1, a + 30], [a + 1, a + 31, a + 30]]
    v.push_dr_mesh(verts.astype(np.float32), np.array(faces),
                   rng.rand(len(verts), 3))


def test_render_against_the_jax_viewer():
    K = (100.0, 100.0, 63.5, 47.5)
    t = make_viewer(K=K)
    j = JViewer(interactive=False, size=(320, 240), K=K)
    _scene(t)
    _scene(j)
    assert np.array_equal(t.points, j.points)
    assert np.array_equal(t.point_colors, j.point_colors)
    V = t.cam.view_matrix()
    assert np.array_equal(V, j.cam.view_matrix())
    traj = np.asarray(t.trajectory)
    for pts in (traj, t.points,
                t._frustum_lines(t.kf_poses[-1])[0]):
        for a, b in zip(t._project(pts, V), j._project(pts, V)):
            assert np.array_equal(a, b)
    a, b = t.render(), j.render()
    delta = np.abs(a.astype(int) - b.astype(int)).max(-1)
    assert (delta > 0).mean() <= RENDER_ANY, (delta > 0).mean()
    assert (delta > 40).mean() <= RENDER_FAR, (delta > 40).mean()


def test_fill_and_lines_against_opencv():
    """Solid triangles and 1-pixel lines where OpenCV draws them without
    anti-aliasing: the same pixels except along the triangles' edges."""
    rng = np.random.RandomState(1)
    img_t = np.zeros((60, 80, 3), np.uint8)
    img_c = np.zeros_like(img_t)
    tri = rng.randint(-10, 90, (12, 3, 2))
    cols = rng.randint(1, 255, (12, 3))
    fill_triangles(img_t, tri, cols)
    for p, c in zip(tri, cols):
        cv2.fillConvexPoly(img_c, p.astype(np.int32),
                           tuple(int(x) for x in c), lineType=cv2.LINE_8)
    assert (np.abs(img_t.astype(int) - img_c).max(-1) > 0).mean() < 0.1
    a, b = rng.randint(-20, 100, (2, 6, 2))
    line_t = np.zeros((60, 80), np.uint8)
    line_c = np.zeros_like(line_t)
    draw_segments(line_t, a, b, 255)
    for p, q in zip(a, b):
        cv2.line(line_c, tuple(int(x) for x in p), tuple(int(x) for x in q),
                 255, 1, cv2.LINE_8)
    assert abs(int((line_t > 0).sum()) - int((line_c > 0).sum())) \
        <= 0.1 * (line_c > 0).sum()


def test_sinks_write_what_the_jax_sinks_write(tmp_path):
    """FileOutputWrapper's depth PNG (the port's always records depths;
    the JAX one with save_depth_images=True) and PanelOutputWrapper's panel
    decode to the images the JAX sinks write with cv2."""
    rng = np.random.RandomState(2)
    depth = (1 + rng.rand(24, 32)).astype(np.float32)
    depth[3:6, 4:9] = 0
    conf = rng.rand(24, 32).astype(np.float32)
    bgr = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
    files = {"t": tout.FileOutputWrapper(str(tmp_path / "t" / "f")),
             "j": jout.FileOutputWrapper(str(tmp_path / "j" / "f"),
                                         save_depth_images=True)}
    for mod, tag in ((tout, "t"), (jout, "j")):
        f = files[tag]
        f.push_dr_kf_depth(depth, conf)
        p = mod.PanelOutputWrapper(str(tmp_path / tag / "p"))
        p.push_dr_kf_image(bgr)
        p.push_dr_kf_depth(depth, conf)
        mod.NullOutputWrapper().push_dr_kf_depth(depth, conf)
    for sub, name in (("f", "kf_depth_000000.png"),
                      ("p", "dr_kf_000000.png")):
        a = read_png(tmp_path / "t" / sub / name)
        b = cv2.imread(str(tmp_path / "j" / sub / name),
                       cv2.IMREAD_UNCHANGED)
        if a.ndim == 3:
            a = a[..., ::-1]
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(tout._rainbow(np.linspace(-1, 2, 50)),
                          jout._rainbow(np.linspace(-1, 2, 50)))
