"""Geometric + photometric camera undistortion.

A copy of ``tandem_tpu/data/undistort.py`` without OpenCV (parity target
tandem/src/util/Undistort.{h,cpp}): camera models Pinhole / FOV / RadTan
(+K3 variant) / Equidistant / KannalaBrandt with rectification modes crop /
full / none, and the PhotometricUndistorter (256-entry inverse response +
vignette image). The per-pixel remap grid is precomputed once; per-frame
remapping is the JAX package's numpy bilinear resample (``remap_u8``). The
vignette PNG is decoded with ``data/replica.read_png``; a vignette whose
size differs from the image raises (the JAX package resizes it with cv2).

Calib file format (Undistort::getUndistorterForFile): line 1 = model +
parameters, line 2 = input size, line 3 = rectified model ("crop" / "full" /
fx fy cx cy), line 4 = output size. Relative (<=1) intrinsics are scaled by
the image size with the DSO +0.5 / -0.5 convention (README tandem §4.1).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .replica import read_png


# --- distortion models: (x, y) normalized cam coords -> distorted normalized
def _distort_radtan(x, y, p):
    k1, k2, r1, r2 = p
    r2_ = x * x + y * y
    scale = 1.0 + k1 * r2_ + k2 * r2_ * r2_
    xd = x * scale + 2.0 * r1 * x * y + r2 * (r2_ + 2.0 * x * x)
    yd = y * scale + 2.0 * r2 * x * y + r1 * (r2_ + 2.0 * y * y)
    return xd, yd


def _distort_radtan8(x, y, p):
    k1, k2, r1, r2, k3 = p[:5]
    r2_ = x * x + y * y
    scale = 1.0 + k1 * r2_ + k2 * r2_ ** 2 + k3 * r2_ ** 3
    xd = x * scale + 2.0 * r1 * x * y + r2 * (r2_ + 2.0 * x * x)
    yd = y * scale + 2.0 * r2 * x * y + r1 * (r2_ + 2.0 * y * y)
    return xd, yd


def _distort_fov(x, y, p):
    w = p[0]
    if abs(w) < 1e-9:
        return x, y
    r = np.sqrt(x * x + y * y)
    fac = np.where(r < 1e-9, 1.0,
                   np.arctan(r * 2.0 * np.tan(w * 0.5)) / (w * np.maximum(r, 1e-9)))
    return x * fac, y * fac


def _distort_equidistant(x, y, p):
    k1, k2, k3, k4 = p
    r = np.sqrt(x * x + y * y)
    theta = np.arctan(r)
    th2 = theta * theta
    thetad = theta * (1 + k1 * th2 + k2 * th2 ** 2 + k3 * th2 ** 3
                      + k4 * th2 ** 4)
    fac = np.where(r < 1e-9, 1.0, thetad / np.maximum(r, 1e-9))
    return x * fac, y * fac


def _distort_kb(x, y, p):
    # KannalaBrandt as in DSO: same polynomial family as equidistant
    return _distort_equidistant(x, y, p)


_MODELS = {
    "pinhole": (0, None),
    "fov": (1, _distort_fov),
    "radtan": (4, _distort_radtan),
    "radtan8": (5, _distort_radtan8),
    "equidistant": (4, _distort_equidistant),
    "kannalabrandt": (4, _distort_kb),
}


class Undistort:
    def __init__(self, model: str, fx, fy, cx, cy, dist_params, in_size,
                 out_size, out_K):
        self.model = model
        self.in_K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
        self.dist = np.asarray(dist_params, np.float64)
        self.in_w, self.in_h = in_size
        self.w, self.h = out_size
        self.K = np.asarray(out_K, np.float64)
        self._build_remap()

    # -- construction ---------------------------------------------------
    @classmethod
    def from_file(cls, path: str):
        lines = [ln.strip() for ln in open(path)
                 if ln.strip() and not ln.startswith("#")]
        toks = lines[0].split()
        name = toks[0].lower()
        if name in _MODELS:
            vals = [float(t) for t in toks[1:]]
        else:
            # legacy numeric-only line: 5 values = FOV/pinhole, 8 = radtan
            vals = [float(t) for t in toks]
            if len(vals) == 5:
                name = "pinhole" if vals[4] == 0 else "fov"
            elif len(vals) == 8:
                name = "radtan"
            else:
                raise ValueError(f"Unknown calib line: {lines[0]}")
            vals = vals[:4] + vals[4:]

        n_dist, _ = _MODELS[name]
        fx, fy, cx, cy = vals[:4]
        dist = vals[4:4 + n_dist] if n_dist else []

        in_w, in_h = [int(v) for v in lines[1].split()[:2]]
        # Relative intrinsics convention (Undistort.cpp; README §4.1)
        if fx <= 1.0 and fy <= 1.0:
            fx = fx * in_w
            fy = fy * in_h
            cx = cx * in_w - 0.5
            cy = cy * in_h - 0.5

        mode = lines[2].split()[0] if len(lines) > 2 else "none"
        out_w, out_h = ([int(v) for v in lines[3].split()[:2]]
                        if len(lines) > 3 else (in_w, in_h))

        tmp = cls.__new__(cls)
        tmp.model = name
        tmp.in_K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        tmp.dist = np.asarray(dist)
        tmp.in_w, tmp.in_h = in_w, in_h
        if mode == "none":
            out_K = tmp.in_K.copy()
        elif mode == "crop":
            out_K = tmp._crop_K(out_w, out_h)
        elif mode == "full":
            out_K = tmp._full_K(out_w, out_h)
        else:
            vals2 = [float(v) for v in lines[2].split()[:4]]
            fx2, fy2, cx2, cy2 = vals2
            if fx2 <= 1.0:
                fx2, fy2 = fx2 * out_w, fy2 * out_h
                cx2, cy2 = cx2 * out_w - 0.5, cy2 * out_h - 0.5
            out_K = np.array([[fx2, 0, cx2], [0, fy2, cy2], [0, 0, 1]])
        return cls(name, fx, fy, cx, cy, dist, (in_w, in_h), (out_w, out_h),
                   out_K)

    def _project_in(self, x, y):
        """Normalized coords -> input pixel coords through the distortion."""
        _, dist_fn = _MODELS[self.model]
        if dist_fn is not None and len(self.dist):
            x, y = dist_fn(x, y, self.dist)
        fx, fy = self.in_K[0, 0], self.in_K[1, 1]
        cx, cy = self.in_K[0, 2], self.in_K[1, 2]
        return fx * x + cx, fy * y + cy

    def _crop_K(self, out_w, out_h):
        """'crop' rectification: largest FOV with no invalid pixels
        (Undistort::makeOptimalK_crop semantics, iterative shrink)."""
        # Sample border rays of the input image, unproject approximately by
        # inverting the distortion numerically on a grid.
        gx, gy = np.meshgrid(np.linspace(-1.2, 1.2, 201),
                             np.linspace(-1.2, 1.2, 201))
        px, py = self._project_in(gx, gy)
        inside = ((px >= 0) & (px <= self.in_w - 1)
                  & (py >= 0) & (py <= self.in_h - 1))
        xs, ys = gx[inside], gy[inside]
        # Shrink to the inscribed axis-aligned box around the center
        min_x, max_x = np.percentile(xs, 1), np.percentile(xs, 99)
        min_y, max_y = np.percentile(ys, 1), np.percentile(ys, 99)
        fx = (out_w - 1) / (max_x - min_x)
        fy = (out_h - 1) / (max_y - min_y)
        cx = -min_x * fx
        cy = -min_y * fy
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])

    def _full_K(self, out_w, out_h):
        gx, gy = np.meshgrid(np.linspace(-2.0, 2.0, 201),
                             np.linspace(-2.0, 2.0, 201))
        px, py = self._project_in(gx, gy)
        inside = ((px >= 0) & (px <= self.in_w - 1)
                  & (py >= 0) & (py <= self.in_h - 1))
        xs, ys = gx[inside], gy[inside]
        min_x, max_x = xs.min(), xs.max()
        min_y, max_y = ys.min(), ys.max()
        fx = (out_w - 1) / (max_x - min_x)
        fy = (out_h - 1) / (max_y - min_y)
        return np.array([[fx, 0, -min_x * fx], [0, fy, -min_y * fy],
                         [0, 0, 1]])

    def _build_remap(self):
        ys, xs = np.meshgrid(np.arange(self.h, dtype=np.float64),
                             np.arange(self.w, dtype=np.float64),
                             indexing="ij")
        nx = (xs - self.K[0, 2]) / self.K[0, 0]
        ny = (ys - self.K[1, 2]) / self.K[1, 1]
        px, py = self._project_in(nx, ny)
        valid = ((px >= 0) & (px <= self.in_w - 1.001)
                 & (py >= 0) & (py <= self.in_h - 1.001))
        self.remap_x = np.where(valid, px, -1).astype(np.float32)
        self.remap_y = np.where(valid, py, -1).astype(np.float32)
        self.remap_valid = valid

    # -- per-frame ------------------------------------------------------
    def undistort_image(self, img: np.ndarray) -> np.ndarray:
        """Bilinear remap; invalid pixels -> 0."""
        x0 = np.clip(np.floor(self.remap_x).astype(int), 0, self.in_w - 2)
        y0 = np.clip(np.floor(self.remap_y).astype(int), 0, self.in_h - 2)
        wx = np.clip(self.remap_x - x0, 0, 1)
        wy = np.clip(self.remap_y - y0, 0, 1)
        if img.ndim == 2:
            img = img[..., None]
        g = (img[y0, x0] * ((1 - wx) * (1 - wy))[..., None]
             + img[y0, x0 + 1] * (wx * (1 - wy))[..., None]
             + img[y0 + 1, x0] * ((1 - wx) * wy)[..., None]
             + img[y0 + 1, x0 + 1] * (wx * wy)[..., None])
        g = np.where(self.remap_valid[..., None], g, 0)
        return g[..., 0] if g.shape[-1] == 1 else g


def remap_u8(src: np.ndarray, map_x: np.ndarray,
             map_y: np.ndarray) -> np.ndarray:
    """Undistort an (H, W) or (H, W, C) uint8 image to float32 through the
    remap grids (the numpy path of the JAX package's ``remap_u8``)."""
    c = 1 if src.ndim == 2 else src.shape[2]
    src = np.ascontiguousarray(src, np.uint8).reshape(src.shape[0],
                                                       src.shape[1], c)
    x0 = np.clip(np.floor(map_x).astype(int), 0, src.shape[1] - 2)
    y0 = np.clip(np.floor(map_y).astype(int), 0, src.shape[0] - 2)
    wx = np.clip(map_x - x0, 0, 1)[..., None]
    wy = np.clip(map_y - y0, 0, 1)[..., None]
    s = src.astype(np.float32)
    out = (s[y0, x0] * (1 - wx) * (1 - wy) + s[y0, x0 + 1] * wx * (1 - wy)
           + s[y0 + 1, x0] * (1 - wx) * wy + s[y0 + 1, x0 + 1] * wx * wy)
    out = np.where(((map_x >= 0) & (map_y >= 0))[..., None], out, 0)
    return out[..., 0] if c == 1 else out


class PhotometricUndistorter:
    """Inverse response (256-entry gamma) + vignette correction
    (Undistort.h:40 PhotometricUndistorter)."""

    def __init__(self, gamma_path: Optional[str] = None,
                 vignette_path: Optional[str] = None,
                 size: Optional[Tuple[int, int]] = None):
        if gamma_path:
            vals = np.loadtxt(gamma_path).reshape(-1)
            assert len(vals) >= 256, "response file needs >= 256 entries"
            g = vals[:256].astype(np.float32)
            # Normalize to [0, 255] output range like the reference
            g = 255.0 * (g - g.min()) / max(g.max() - g.min(), 1e-9)
            self.inv_response = g
        else:
            self.inv_response = np.arange(256, dtype=np.float32)

        self.is_identity = not gamma_path  # becomes False below if vignette
        self.vignette_inv = None
        if vignette_path:
            vg = read_png(vignette_path)
            if vg.ndim == 3:                      # as cv2 reads it: BGR
                vg = vg[..., ::-1]
            vg = vg.astype(np.float32)
            vg = vg / max(vg.max(), 1e-9)
            if size is not None and (vg.shape[1], vg.shape[0]) != size:
                raise ValueError(
                    f"vignette {vignette_path} is {vg.shape[1]}x"
                    f"{vg.shape[0]}, the images {size[0]}x{size[1]}")
            self.vignette_inv = 1.0 / np.maximum(vg, 1e-3)
            self.is_identity = False

    def process(self, img_u8: np.ndarray) -> np.ndarray:
        out = self.inv_response[img_u8.astype(np.int64)]
        if self.vignette_inv is not None:
            if self.vignette_inv.shape[:2] != img_u8.shape[:2]:
                raise ValueError(
                    f"vignette is {self.vignette_inv.shape[1]}x"
                    f"{self.vignette_inv.shape[0]}, the image "
                    f"{img_u8.shape[1]}x{img_u8.shape[0]}")
            out = out * self.vignette_inv
        return out.astype(np.float32)
