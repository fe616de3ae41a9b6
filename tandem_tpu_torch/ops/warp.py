"""Plane-sweep homography warp.

Port of the plain path of ``tandem_tpu/ops/warp.py`` (reference
cva_mvsnet/models/module.py:764-908): for every reference pixel and depth
hypothesis, project into the source view via
K_src [R|t]_src^-1 . ([R|t]_ref K_ref^-1) and sample the source features
bilinearly. Projections behind the source camera (z < min_depth_thres)
contribute zero, and the division uses z clamped away from 0 at 1e-12 —
the reference produces NaN there and zeroes it afterwards; both give zero.

Positions and ``mask_valid`` are float32 torch code. The sample is the
JAX package's ``_plain`` path (warp.py:118-157): kernel P5 turns the
positions into packed-corner rows (batch folded into the row index) and
weights cast to the features' dtype, kernel P3 reads and blends the rows
(``ops/grid_sample.sample_packed``). ``plane_group`` and its grouped patch
gather are a TPU gather-throughput trick and have no counterpart here.
"""

from __future__ import annotations

import torch

from .grid_sample import sample_packed
from .linalg import invert_pixel_projection


def _rigid_inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ t)], -1)
    bottom = torch.zeros_like(T[..., 3:4, :])
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], -2)


def _pixel_projection_matrix(K, world_to_cam):
    """4x4 world->pixel matrix: rows 0..2 = K @ [R|t], row 3 = (0,0,0,1)."""
    return torch.cat([K @ world_to_cam[:, :3, :4], world_to_cam[:, 3:4, :]], 1)


def plane_sweep_warp(src_features, ref_depth, *, src_K, src_cam_to_world,
                     ref_K, ref_cam_to_world, min_depth_thres: float = 0.001):
    """Warp source features over reference depth hypotheses.

    :param src_features: (B, H, W, C)
    :param ref_depth: (B, D, H, W) depth hypotheses in the reference frame
    :param src_K, ref_K: (B, 3, 3)
    :param src_cam_to_world, ref_cam_to_world: (B, 4, 4)
    :return: warped (B, D, H, W, C), mask_valid (B, D, H, W), both of
        src_features' dtype
    """
    B, H, W, C = src_features.shape
    f32 = torch.float32
    dev = src_features.device

    src_w2p = _pixel_projection_matrix(
        src_K.to(f32), _rigid_inverse(src_cam_to_world.to(f32)))
    ref_p2w = invert_pixel_projection(ref_K.to(f32),
                                      ref_cam_to_world.to(f32))
    ref_to_src = src_w2p @ ref_p2w
    rot = ref_to_src[:, :3, :3]
    trans = ref_to_src[:, :3, 3]

    gy, gx = torch.meshgrid(torch.arange(H, dtype=f32, device=dev),
                            torch.arange(W, dtype=f32, device=dev),
                            indexing="ij")
    depth = ref_depth.to(f32)

    def proj_component(i):
        # rot[i] @ [x, y, 1] per pixel, then * depth + trans[i]
        dir_i = (rot[:, i, 0, None, None] * gx
                 + rot[:, i, 1, None, None] * gy
                 + rot[:, i, 2, None, None])              # (B, H, W)
        return dir_i[:, None] * depth + trans[:, i, None, None, None]

    z = proj_component(2)                                 # (B, D, H, W)
    z_safe = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    px = proj_component(0) / z_safe
    py = proj_component(1) / z_safe

    x_norm = px / (0.5 * (W - 1)) - 1.0
    y_norm = py / (0.5 * (H - 1)) - 1.0
    mask_negative = z < min_depth_thres
    mask_outside = ((x_norm.abs() > 1.0 + 1.0 / (W - 1))
                    | (y_norm.abs() > 1.0 + 1.0 / (H - 1)))
    mask_valid = ~(mask_negative | mask_outside)

    warped = sample_packed(src_features, px, py, keep=~mask_negative)
    return warped, mask_valid.to(src_features.dtype)
