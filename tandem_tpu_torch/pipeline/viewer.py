"""Software-rasterized 3D viewer, the PangolinDSOViewer substitute.

Port of ``tandem_tpu/pipeline/viewer.py`` (parity target
tandem/src/IOWrapper/Pangolin/PangolinDSOViewer.{h,cpp}): the camera
trajectory, keyframe frusta (KeyFrameDisplay), the fused TANDEM mesh
(pushDrMesh, PangolinDSOViewer.cpp:803) and the dense keyframe depth as a
coloured point cloud, with the panel toggles (follow camera, show
trajectory / keyframes / mesh / points) as attributes. A numpy painter's
rasterizer renders the scene state, in the JAX viewer's draw order:

  horizon grid, mesh triangles flat-shaded by face normal (back to front),
  the point cloud coloured by the rainbow idepth ramp (z-sorted), the
  trajectory polyline (green), keyframe frusta (blue; current camera red).

The card's machine has no OpenCV, so the triangle fill and the line drawer
are this module's own (``fill_triangles``, ``draw_segments``): solid
one-colour lines in place of cv2.line's anti-aliased ones, and a fill of
the pixels whose centres lie inside or on a triangle in place of
cv2.fillConvexPoly. Projections, the point cloud and the shading are the
JAX viewer's arithmetic. There is no interactive window (HighGUI): the
port records every render as a numbered PNG under ``out_dir``.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

import numpy as np

from ..data.replica import write_png
from .output_wrapper import Output3DWrapper, _rainbow


class ViewCamera:
    """Orbit camera: azimuth/elevation/radius around a target point."""

    def __init__(self):
        self.azimuth = -0.5
        self.elevation = -0.45
        self.radius = 6.0
        self.target = np.zeros(3)

    def view_matrix(self) -> np.ndarray:
        """world -> view (4, 4), right-handed, camera looks down +z."""
        ca, sa = np.cos(self.azimuth), np.sin(self.azimuth)
        ce, se = np.cos(self.elevation), np.sin(self.elevation)
        off = np.array([self.radius * ca * ce, self.radius * se,
                        self.radius * sa * ce])
        eye = self.target + off
        fwd = self.target - eye
        fwd = fwd / np.linalg.norm(fwd)
        up0 = np.array([0.0, -1.0, 0.0])  # DSO world: y points down
        right = np.cross(fwd, up0)
        n = np.linalg.norm(right)
        if n < 1e-6:
            right = np.array([1.0, 0.0, 0.0])
        else:
            right = right / n
        up = np.cross(fwd, right)
        V = np.eye(4)
        V[0, :3], V[1, :3], V[2, :3] = right, up, fwd
        V[:3, 3] = -V[:3, :3] @ eye
        return V


def draw_segments(img: np.ndarray, a: np.ndarray, b: np.ndarray, color,
                  thickness: int = 1):
    """Draw the integer pixel segments a[i] -> b[i] ((M, 2) x, y) in one
    colour, clipped to the image: 1 pixel wide, or 2 * (thickness // 2) + 1
    for a wider one."""
    if len(a) == 0:
        return
    H, W = img.shape[:2]
    a = np.asarray(a, np.int64)
    d = np.asarray(b, np.int64) - a
    n = np.abs(d).max(1) + 1                       # samples a segment
    seg = np.repeat(np.arange(len(a)), n)
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    t = k / np.maximum(n[seg] - 1, 1)
    x = np.floor(a[seg, 0] + t * d[seg, 0] + 0.5).astype(np.int64)
    y = np.floor(a[seg, 1] + t * d[seg, 1] + 0.5).astype(np.int64)
    # a square brush; a wide line one pixel wider, as OpenCV's anti-aliased
    # wide lines spread
    r = thickness // 2
    for oy in range(-r, r + 1):
        for ox in range(-r, r + 1):
            xx, yy = x + ox, y + oy
            ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            img[yy[ok], xx[ok]] = color


def fill_triangles(img: np.ndarray, tri: np.ndarray, colors: np.ndarray,
                   chunk: int = 1 << 22):
    """Fill the integer pixel triangles ``tri`` ((T, 3, 2) x, y) with
    ``colors`` ((T, 3)) in order: a later triangle paints over an earlier
    one (the painter's algorithm). A pixel is covered when its centre lies
    inside or on the triangle; a degenerate triangle covers its line."""
    H, W = img.shape[:2]
    tri = np.asarray(tri, np.int64)
    lo = np.clip(tri.min(1), 0, [W - 1, H - 1])
    hi = np.clip(tri.max(1), 0, [W - 1, H - 1])
    seen = ((tri.max(1) >= 0) & (tri.min(1) < [W, H])).all(1)
    idx = np.nonzero(seen)[0]
    span = hi[idx] - lo[idx] + 1
    area = span[:, 0] * span[:, 1]
    best = np.full(H * W, -1, np.int64)            # the latest triangle
    start = 0
    while start < len(idx):
        stop = start + max(int(np.searchsorted(
            np.cumsum(area[start:]), chunk, side="right")), 1)
        ti = np.repeat(idx[start:stop], area[start:stop])
        k = np.arange(len(ti)) - np.repeat(
            np.cumsum(area[start:stop]) - area[start:stop], area[start:stop])
        w = np.repeat(span[start:stop, 0], area[start:stop])
        px = lo[ti, 0] + k % w
        py = lo[ti, 1] + k // w
        v = tri[ti]
        e = [(v[:, j1, 0] - v[:, j0, 0]) * (py - v[:, j0, 1])
             - (v[:, j1, 1] - v[:, j0, 1]) * (px - v[:, j0, 0])
             for j0, j1 in ((0, 1), (1, 2), (2, 0))]
        inside = (((e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0))
                  | ((e[0] <= 0) & (e[1] <= 0) & (e[2] <= 0)))
        np.maximum.at(best, (py * W + px)[inside], ti[inside])
        start = stop
    hit = best >= 0
    img.reshape(H * W, -1)[hit] = colors[best[hit]]


class Viewer3DWrapper(Output3DWrapper):
    """An Output3DWrapper that renders the 3D scene.

    :param size: (width, height) of the render canvas
    :param K: optional (fx, fy, cx, cy) of the SLAM camera, to back-project
        pushed keyframe depths into the world point cloud (KeyFrameDisplay
        semantics); without it depth pushes draw nothing
    :param out_dir: when set, every render on a push is saved as
        view3d_NNNNNN.png (PangolinDSOViewer's video-record analogue)
    :param interactive: an interactive window needs OpenCV's HighGUI,
        which the card's machine lacks: True raises
    """

    MAX_TRI = 60000          # painter budget per frame
    MAX_PTS = 120000
    POINT_STRIDE = 4         # keyframe depths back-projected every 4th pixel

    def __init__(self, size=(960, 540), K=None, out_dir: Optional[str] = None,
                 interactive: bool = False):
        if interactive:
            raise NotImplementedError(
                "the interactive 3D window needs OpenCV's HighGUI, which the "
                "port does not use: it records PNGs under out_dir")
        self.W, self.H = int(size[0]), int(size[1])
        self.K = K
        self.out_dir = out_dir
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        self.cam = ViewCamera()
        self.lock = threading.Lock()
        # Scene state
        self.trajectory: List[np.ndarray] = []
        self.kf_poses: List[np.ndarray] = []
        self.current_c2w: Optional[np.ndarray] = None
        self.points: Optional[np.ndarray] = None      # (N, 3)
        self.point_colors: Optional[np.ndarray] = None  # (N, 3) uint8 BGR
        self.mesh: Optional[tuple] = None             # (verts, faces, cols)
        self._last_kf_c2w: Optional[np.ndarray] = None
        self._frame_count = 0
        # Panel toggles (the PangolinDSOViewer checkboxes)
        self.follow = True
        self.show_trajectory = True
        self.show_kfs = True
        self.show_mesh = True
        self.show_points = True

    # -- Output3DWrapper sink API --------------------------------------
    def publish_cam_pose(self, frame_id, c2w):
        with self.lock:
            c2w = np.asarray(c2w, np.float64)
            self.trajectory.append(c2w[:3, 3].copy())
            self.current_c2w = c2w
            if self.follow:
                self.cam.target = c2w[:3, 3].copy()

    def publish_keyframes(self, keyframes):
        with self.lock:
            self.kf_poses = [np.asarray(kf.c2w, np.float64)
                             for kf in keyframes]
            if self.kf_poses:
                self._last_kf_c2w = self.kf_poses[-1]

    def push_dr_kf_depth(self, depth, confidence):
        """Back-project the MVS keyframe depth into a world point cloud
        (KeyFrameDisplay / DrFrameDisplay point rendering)."""
        if self.K is None or self._last_kf_c2w is None:
            return
        d = np.asarray(depth, np.float32)
        fx, fy, cx, cy = self.K
        s = self.POINT_STRIDE
        ds = d[::s, ::s]
        v, u = np.mgrid[0:d.shape[0]:s, 0:d.shape[1]:s].astype(np.float32)
        ok = ds > 0
        z = ds[ok]
        x = (u[ok] - cx) / fx * z
        y = (v[ok] - cy) / fy * z
        pts_cam = np.stack([x, y, z], -1)
        R, t = self._last_kf_c2w[:3, :3], self._last_kf_c2w[:3, 3]
        pts = pts_cam @ R.T + t
        idep = 1.0 / np.maximum(z, 1e-6)
        hi = np.percentile(idep, 98) if idep.size else 1.0
        cols = _rainbow(idep / max(hi, 1e-6))
        with self.lock:
            if self.points is None:
                self.points, self.point_colors = pts, cols
            else:
                self.points = np.concatenate([self.points, pts])[-self.MAX_PTS:]
                self.point_colors = np.concatenate(
                    [self.point_colors, cols])[-self.MAX_PTS:]
        self._maybe_record()

    def push_dr_mesh(self, vertices, faces, colors=None):
        with self.lock:
            self.mesh = (np.asarray(vertices, np.float32),
                         np.asarray(faces, np.int64),
                         None if colors is None
                         else np.asarray(colors))
        self._maybe_record()

    # -- rendering ------------------------------------------------------
    def _project(self, pts_w: np.ndarray, V: np.ndarray):
        """world (N, 3) -> pixel (N, 2), depth (N,), valid (N,). Simple
        pinhole with focal = H (a ~53 deg vertical FOV like the
        reference's default view)."""
        pv = pts_w @ V[:3, :3].T + V[:3, 3]
        z = pv[:, 2]
        valid = z > 0.05
        zs = np.where(valid, z, 1.0)
        f = float(self.H)
        px = pv[:, 0] / zs * f + self.W / 2.0
        py = pv[:, 1] / zs * f + self.H / 2.0
        valid &= (px > -4 * self.W) & (px < 5 * self.W) \
            & (py > -4 * self.H) & (py < 5 * self.H)
        return np.stack([px, py], -1), z, valid

    @staticmethod
    def _frustum_lines(c2w, scale=0.12):
        w, h, z = 0.8 * scale, 0.5 * scale, scale
        c = np.array([[0, 0, 0], [w, h, z], [w, -h, z], [-w, -h, z],
                      [-w, h, z]])
        pts = c @ c2w[:3, :3].T + c2w[:3, 3]
        idx = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4),
               (4, 1)]
        return pts, idx

    def render(self, canvas: Optional[np.ndarray] = None) -> np.ndarray:
        """Rasterize the current scene; returns (H, W, 3) uint8 BGR."""
        with self.lock:
            traj = np.asarray(self.trajectory, np.float64) \
                if self.trajectory else None
            kfs = list(self.kf_poses)
            cur = self.current_c2w
            pts = None if self.points is None else self.points.copy()
            cols = None if self.point_colors is None \
                else self.point_colors.copy()
            mesh = self.mesh
            V = self.cam.view_matrix()
        img = canvas if canvas is not None else np.full(
            (self.H, self.W, 3), 18, np.uint8)

        # Ground grid (orientation cue; Pangolin's gl grid)
        for gv in np.arange(-5, 6, 1.0):
            for seg in ([[gv, 1.5, -5], [gv, 1.5, 5]],
                        [[-5, 1.5, gv], [5, 1.5, gv]]):
                self._draw_line(img, np.asarray(seg, np.float64), V,
                                (40, 40, 40), 1)

        # Mesh (painter's algorithm, flat shading by face normal)
        if self.show_mesh and mesh is not None and len(mesh[1]):
            verts, faces, vcols = mesh
            if len(faces) > self.MAX_TRI:
                faces = faces[:: int(np.ceil(len(faces) / self.MAX_TRI))]
            p2, z, ok = self._project(verts, V)
            f2 = faces[ok[faces].all(axis=1)]
            if len(f2):
                order = np.argsort(-z[f2].mean(axis=1))     # back to front
                e1 = verts[f2[:, 1]] - verts[f2[:, 0]]
                e2 = verts[f2[:, 2]] - verts[f2[:, 0]]
                n = np.cross(e1, e2)
                n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True),
                                1e-9)
                shade = (0.35 + 0.65 * np.abs(n @ np.array([0.3, -0.8,
                                                            0.52])))
                if vcols is not None:
                    base = vcols[f2].mean(axis=1)
                    if base.max() <= 1.0:
                        base = base * 255.0
                    base = base[:, ::-1]     # RGB -> BGR
                else:
                    base = np.full((len(f2), 3), 170.0)
                tri_px = p2[f2].astype(np.int32)
                col = np.clip(base * shade[:, None], 0, 255).astype(int)
                fill_triangles(img, tri_px[order], col[order])

        # Point cloud (z-sorted scatter)
        if self.show_points and pts is not None and len(pts):
            p2, z, ok = self._project(pts, V)
            p2i = p2[ok].astype(np.int32)
            c2 = cols[ok]
            zo = np.argsort(-z[ok])
            p2i, c2 = p2i[zo], c2[zo]
            inb = ((p2i[:, 0] >= 0) & (p2i[:, 0] < self.W)
                   & (p2i[:, 1] >= 0) & (p2i[:, 1] < self.H))
            p2i, c2 = p2i[inb], c2[inb]
            img[p2i[:, 1], p2i[:, 0]] = c2

        # Trajectory polyline
        if self.show_trajectory and traj is not None and len(traj) > 1:
            self._draw_line(img, traj, V, (80, 220, 80), 2)

        # Keyframe frusta + current camera
        if self.show_kfs:
            for c2w in kfs:
                self._draw_frustum(img, c2w, V, (230, 140, 60))
        if cur is not None:
            self._draw_frustum(img, cur, V, (60, 60, 235), scale=0.16)
        return img

    def _draw_line(self, img, pts_w, V, color, thick):
        p2, _, ok = self._project(np.asarray(pts_w, np.float64), V)
        p2 = p2.astype(np.int32)
        both = ok[:-1] & ok[1:]
        draw_segments(img, p2[:-1][both], p2[1:][both], color, thick)

    def _draw_frustum(self, img, c2w, V, color, scale=0.12):
        pts, idx = self._frustum_lines(np.asarray(c2w, np.float64), scale)
        p2, _, ok = self._project(pts, V)
        p2 = p2.astype(np.int32)
        a, b = np.array(idx).T
        both = ok[a] & ok[b]
        draw_segments(img, p2[a[both]], p2[b[both]], color, 1)

    def _maybe_record(self):
        if not self.out_dir:
            return
        self.snapshot(os.path.join(self.out_dir,
                                   f"view3d_{self._frame_count:06d}.png"))
        self._frame_count += 1

    def join(self):
        """No window thread to stop (the sink API's teardown)."""

    def snapshot(self, path: str):
        """Write the current render as an RGB PNG (BGR canvas)."""
        write_png(path, np.ascontiguousarray(self.render()[..., ::-1]))
