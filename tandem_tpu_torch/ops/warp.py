"""Plane-sweep homography warp.

Port of the plain path of ``tandem_tpu/ops/warp.py`` (reference
cva_mvsnet/models/module.py:764-908): for every reference pixel and depth
hypothesis, project into the source view via
K_src [R|t]_src^-1 . ([R|t]_ref K_ref^-1) and sample the source features
bilinearly. Projections behind the source camera (z < min_depth_thres)
contribute zero, and the division uses z clamped away from 0 at 1e-12 —
the reference produces NaN there and zeroes it afterwards; both give zero.

The 4x4 matrices are float32 torch code (~65 small launches a view, or
~20 when the caller passes the reference's pixel -> world matrix, which
every source view of a stage shares); the rest is one launch of
``ops/bilinear_sample.warp_sample`` (``csrc/bilinear_sample.cu``), which
computes each sample's position from the ref->src matrix and its depth,
and reads the four corners straight from the NHWC features: no position,
weight or packed-corner table reaches device memory. ``mask_valid`` is
torch code over the same positions (``sweep_positions``) and is computed
only when asked for: the cascade discards it
(tandem_tpu/ops/warp.py:141-142). ``plane_group`` and its grouped patch
gather are a TPU gather-throughput trick and have no counterpart here.
"""

from __future__ import annotations

import torch

from .bilinear_sample import (sweep_positions, warp_correlation, warp_sample,
                              warp_variance)
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
    return torch.cat([K @ world_to_cam[..., :3, :4],
                      world_to_cam[..., 3:4, :]], -2)


def ref_pixel_to_world(ref_K, ref_cam_to_world):
    """The reference's pixel -> world matrix (4x4, float32): the same for
    every source view of a stage, so a caller may compute it once."""
    return invert_pixel_projection(ref_K.to(torch.float32),
                                   ref_cam_to_world.to(torch.float32))


def ref_to_src_matrix(src_K, src_cam_to_world, ref_K=None,
                      ref_cam_to_world=None, ref_p2w=None):
    """Rows 0-2 of the ref pixel -> src pixel projection, float32.

    :param src_K, ref_K: (..., 3, 3); src/ref_cam_to_world: (..., 4, 4)
    :param ref_p2w: ``ref_pixel_to_world(ref_K, ref_cam_to_world)``, if
        the caller has it (then ref_K and ref_cam_to_world are not read)
    :return: (..., 3, 4) float32, contiguous
    """
    f32 = torch.float32
    src_w2p = _pixel_projection_matrix(
        src_K.to(f32), _rigid_inverse(src_cam_to_world.to(f32)))
    if ref_p2w is None:
        ref_p2w = ref_pixel_to_world(ref_K, ref_cam_to_world)
    return (src_w2p @ ref_p2w)[..., :3, :].contiguous()


def plane_sweep_warp(src_features, ref_depth, *, src_K, src_cam_to_world,
                     ref_K, ref_cam_to_world, min_depth_thres: float = 0.001,
                     with_mask: bool = True, ref_p2w=None):
    """Warp source features over reference depth hypotheses.

    :param src_features: (B, H, W, C)
    :param ref_depth: (B, D, H, W) depth hypotheses in the reference frame
    :param src_K, ref_K: (B, 3, 3)
    :param src_cam_to_world, ref_cam_to_world: (B, 4, 4)
    :param with_mask: False skips ``mask_valid`` (returned as None)
    :param ref_p2w: ``ref_pixel_to_world(ref_K, ref_cam_to_world)``, if
        the caller has it: the same matrix, not computed again
    :return: warped (B, D, H, W, C), mask_valid (B, D, H, W), both of
        src_features' dtype
    """
    B, H, W, C = src_features.shape
    mat = ref_to_src_matrix(src_K, src_cam_to_world, ref_K, ref_cam_to_world,
                            ref_p2w)
    depth = ref_depth.to(torch.float32).contiguous()
    warped = warp_sample(src_features.contiguous(), mat, depth,
                         min_depth_thres)
    if not with_mask:
        return warped, None
    px, py, z = sweep_positions(mat, depth, H, W)
    x_norm = px / (0.5 * (W - 1)) - 1.0
    y_norm = py / (0.5 * (H - 1)) - 1.0
    mask_negative = z < min_depth_thres
    mask_outside = ((x_norm.abs() > 1.0 + 1.0 / (W - 1))
                    | (y_norm.abs() > 1.0 + 1.0 / (H - 1)))
    mask_valid = ~(mask_negative | mask_outside)
    return warped, mask_valid.to(src_features.dtype)


def plane_sweep_variance(src_features, ref_depth, sums=None, *, src_K,
                         src_cam_to_world, ref_p2w,
                         min_depth_thres: float = 0.001):
    """One source view's step of the variance cost volume:
    ``plane_sweep_warp``'s warped features x, never held whole, added to
    the running sums of x and x * x (``ops/bilinear_sample.warp_variance``:
    in place, or written when ``sums`` is None).

    :param src_features: (B, H, W, C); ref_depth: (B, D, H, W)
    :param ref_p2w: ``ref_pixel_to_world`` of the reference
    :return: (sum, sum of squares), each (B, D, H, W, C) of
        src_features' dtype
    """
    mat = ref_to_src_matrix(src_K, src_cam_to_world, ref_p2w=ref_p2w)
    return warp_variance(src_features.contiguous(), mat,
                         ref_depth.to(torch.float32).contiguous(), sums,
                         min_depth_thres)


def plane_sweep_correlation(src_features, ref_features, ref_depth, *, src_K,
                            src_cam_to_world, ref_p2w,
                            min_depth_thres: float = 0.001):
    """One source view's step of the correlation cost volume:
    ``plane_sweep_warp``'s warped features x, never held whole, times the
    reference's features r at the same pixel and averaged over the
    channels, (1 / C) sum_c r_c x_c (``ops/bilinear_sample.
    warp_correlation``).

    :param src_features, ref_features: (B, H, W, C) of one dtype
    :param ref_depth: (B, D, H, W)
    :param ref_p2w: ``ref_pixel_to_world`` of the reference
    :return: (B, D, H, W) float32
    """
    mat = ref_to_src_matrix(src_K, src_cam_to_world, ref_p2w=ref_p2w)
    return warp_correlation(src_features.contiguous(),
                            ref_features.contiguous(), mat,
                            ref_depth.to(torch.float32).contiguous(),
                            min_depth_thres)
