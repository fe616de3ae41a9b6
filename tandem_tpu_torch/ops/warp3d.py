"""Depth-map reprojection warp (ref -> src -> ref).

Port of ``tandem_tpu/ops/warp3d.py`` (parity target homo_warping_3d,
cva_mvsnet/models/module.py:911-1013): for each reference pixel at its
reference depth, look up the source depth at the projected location
(``ops/grid_sample.bilinear_sample_pixel``, kernels P5 + P3), then
reproject that source depth back into the reference view — yielding the
corresponding pixel, its depth in the reference frame, and a validity mask.
Used for cross-view depth consistency checks.
"""

from __future__ import annotations

import torch

from .grid_sample import bilinear_sample_pixel
from .linalg import invert_pixel_projection
from .warp import _pixel_projection_matrix, _rigid_inverse


def _safe(z):
    return torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)


def depth_reprojection_warp(src_depth, ref_depth, *, src_K, src_cam_to_world,
                            ref_K, ref_cam_to_world,
                            min_depth_thres: float = 0.001):
    """:param src_depth: (B, H, W); ref_depth: (B, H, W)
    :param src_K, ref_K: (B, 3, 3); src/ref_cam_to_world: (B, 4, 4)
    :return: proj_pixel (B, H, W, 2), proj_depth (B, H, W), mask (B, H, W)
        float32
    """
    B, H, W = ref_depth.shape
    f32 = torch.float32
    dev = ref_depth.device
    src_K, ref_K = src_K.to(f32), ref_K.to(f32)
    src_c2w, ref_c2w = src_cam_to_world.to(f32), ref_cam_to_world.to(f32)

    ref_to_src = (_pixel_projection_matrix(src_K, _rigid_inverse(src_c2w))
                  @ invert_pixel_projection(ref_K, ref_c2w))
    gy, gx = torch.meshgrid(torch.arange(H, dtype=f32, device=dev),
                            torch.arange(W, dtype=f32, device=dev),
                            indexing="ij")
    xyz = torch.stack([gx.reshape(-1), gy.reshape(-1),
                       torch.ones(H * W, dtype=f32, device=dev)])
    proj = (ref_to_src[:, :3, :3] @ xyz) * ref_depth.to(f32).reshape(B, 1, -1) \
        + ref_to_src[:, :3, 3, None]
    z = proj[:, 2]
    z_safe = _safe(z)
    px = proj[:, 0] / z_safe
    py = proj[:, 1] / z_safe

    mask_neg = z < min_depth_thres
    x_norm = px / (0.5 * (W - 1)) - 1.0
    y_norm = py / (0.5 * (H - 1)) - 1.0
    mask_out = ((x_norm.abs() > 1.0 + 1.0 / (W - 1))
                | (y_norm.abs() > 1.0 + 1.0 / (H - 1)))

    # Sample the source depth at the projected pixels.
    d_src = bilinear_sample_pixel(src_depth.to(f32)[..., None], px, py)[..., 0]

    # Reproject with the source depth back into the reference view.
    src_to_ref = (_pixel_projection_matrix(ref_K, _rigid_inverse(ref_c2w))
                  @ invert_pixel_projection(src_K, src_c2w))
    pxy1 = torch.stack([px, py, torch.ones_like(px)], 1)       # (B, 3, HW)
    back = (src_to_ref[:, :3, :3] @ pxy1) * d_src[:, None, :] \
        + src_to_ref[:, :3, 3, None]
    bz = back[:, 2]
    bz_safe = _safe(bz)
    out_px = back[:, 0] / bz_safe
    out_py = back[:, 1] / bz_safe

    mask = ~(mask_neg | (bz < min_depth_thres) | mask_out)
    proj_pixel = torch.stack([out_px, out_py], -1).reshape(B, H, W, 2)
    return proj_pixel, bz.reshape(B, H, W), mask.to(f32).reshape(B, H, W)
