"""The plane-sweep sample in one launch: bilinear sampling of an NHWC image
straight from the image.

``warp_sample`` (plane sweep: the positions come from the ref->src matrix
and the depth hypotheses) and ``bilinear_sample`` (given positions) launch
the hand-written CUDA kernel ``csrc/bilinear_sample.cu`` for CUDA tensors
and use ``warp_sample_plain`` / ``bilinear_sample_plain`` for CPU tensors.
There is no fallback: a CUDA tensor goes through the kernel or the call
raises. The kernel takes the place, on the main path, of kernels P5
(``ops/bilinear_index.py``) and P3 (``ops/corner_blend.py``) around the
packed-corner table, and of the position math of ``ops/warp.py``.

Semantics: ``grid_sample`` bilinear with ``align_corners=True`` in pixel
coordinates and zero padding; corners outside the image read zero, and
dropped samples get zero weights. The plain versions chain the plain
pieces of that older path (the positions as ``ops/warp.py`` computed them,
``bilinear_index_plain``, ``pack_corners``, ``corner_blend_plain``), and the
kernel equals them bit for bit.
"""

from __future__ import annotations

import functools
import struct

import torch
import torch.nn.functional as F

from ._build import launch
from .bilinear_index import bilinear_index_plain, table_rows
from .corner_blend import _vec, corner_blend_plain

DTYPES = (torch.float32, torch.bfloat16)
# The plane-sweep kernel's tiling: a block is 8 warps of 32 samples of
# one row, over SWEEP_ROWS_PER_BLOCK rows (1, 2, 4 or 8), and a warp walks
# 1, 2 or 4 consecutive depth planes of its samples (``sweep_tiling``).
SWEEP_ROWS_PER_BLOCK = 8
# CUDA's grid limit on the kernel's plane axis, and the image size its
# 32-bit offsets and 16-bit cell coordinates take.
MAX_PLANES = 65535
MAX_SIDE = 65534
MAX_VALUES = 2 ** 31


def pack_corners(img):
    """(B, H, W, C) -> (B, H+1, W+1, 4C) zero-padded corner table.

    Row (y, x) holds [v(y,x), v(y,x+1), v(y+1,x), v(y+1,x+1)] of the padded
    image, so row (y0+1, x0+1) holds all four corners of the cell whose
    top-left is (y0, x0) in image coordinates, for y0, x0 in
    [-1, H-1] x [-1, W-1]."""
    p = F.pad(img, (0, 0, 1, 1, 1, 1))
    return torch.cat([p[:, :-1, :-1], p[:, :-1, 1:],
                      p[:, 1:, :-1], p[:, 1:, 1:]], -1)


def sweep_positions(ref_to_src, depth, H: int, W: int):
    """Source pixel positions of every reference pixel and depth
    hypothesis, in the JAX package's order (tandem_tpu/ops/warp.py:96-106).

    :param ref_to_src: (B, 3, 4) float32 ref pixel -> src pixel projection
    :param depth: (B, D, H, W) float32
    :return: px, py, z, each (B, D, H, W) float32
    """
    f32 = torch.float32
    gy, gx = torch.meshgrid(torch.arange(H, dtype=f32, device=depth.device),
                            torch.arange(W, dtype=f32, device=depth.device),
                            indexing="ij")

    def proj_component(i):
        # ref_to_src[i, :3] @ [x, y, 1] per pixel, then * depth + t_i
        dir_i = (ref_to_src[:, i, 0, None, None] * gx
                 + ref_to_src[:, i, 1, None, None] * gy
                 + ref_to_src[:, i, 2, None, None])        # (B, H, W)
        return dir_i[:, None] * depth + ref_to_src[:, i, 3, None, None, None]

    z = proj_component(2)
    z_safe = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return proj_component(0) / z_safe, proj_component(1) / z_safe, z


def bilinear_sample_plain(img, px, py, keep=None):
    """P5's and P3's plain versions around the packed-corner table.

    :param img: (B, H, W, C); px, py: float32 (B, ...); keep: bool of px's
        shape or None
    :return: (B, ..., C) of img's dtype
    """
    B, H, W, C = img.shape
    rows, weights = bilinear_index_plain(px, py, H, W, keep, B, img.dtype)
    table = pack_corners(img).reshape(B * table_rows(H, W), 4 * C)
    out = corner_blend_plain(table, rows.reshape(-1), weights.reshape(4, -1))
    return out.reshape(*px.shape, C)


def warp_sample_plain(img, ref_to_src, depth, min_depth_thres: float = 0.001):
    """The positions, then ``bilinear_sample_plain``; samples with
    z < min_depth_thres (behind the source camera) are dropped.

    :return: (B, D, H, W, C) of img's dtype
    """
    H, W = img.shape[1:3]
    px, py, z = sweep_positions(ref_to_src, depth, H, W)
    return bilinear_sample_plain(img, px, py, keep=~(z < min_depth_thres))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sweep_tiling(B: int, D: int, H: int, W: int, lanes: int,
                 sms: int) -> tuple:
    """(rows a block, planes a warp) of the plane-sweep kernel, for
    ``lanes`` = C / vec lanes a sample on a card of ``sms`` SMs.

    Several planes a warp hide the depth load's DRAM latency where a
    plane is a few rounds (lanes < 8), but cost blocks: they stay while
    the grid keeps 4 blocks an SM. Chosen from the settings timed by
    ``experiments/sample_tiles.py`` on the H100 at the abl04 stages."""
    rows = SWEEP_ROWS_PER_BLOCK
    if lanes < 8:
        tiles = B * -(-W // (256 // rows)) * -(-H // rows)
        for planes in (4, 2):
            if tiles * -(-D // planes) >= 4 * sms:
                return rows, planes
    return rows, 1


def _too_large(H: int, W: int, C: int) -> bool:
    return max(H, W) > MAX_SIDE or (H + 1) * (W + 1) * C >= MAX_VALUES


@functools.cache
def _plan(B: int, D: int, H: int, W: int, C: int, elem: int, misalign: int,
          index: int) -> tuple:
    """(vec, rows a block, planes a warp) of a plane sweep whose image
    starts ``misalign`` bytes past a 16-byte boundary."""
    vec = _vec(C, elem, misalign)
    return (vec, *sweep_tiling(B, D, H, W, C // vec, _sm_count(index)))


# The layouts of SweepArgs and SampleArgs in csrc/bilinear_sample.cu: the
# pointers, the int64s, the int32s and floats, 80 bytes each.
_SWEEP_ARGS = struct.Struct("<4Q2q7if")
_SAMPLE_ARGS = struct.Struct("<5Q2q6i")


def _check(name: str, img, floats, keep=None):
    """Types, layouts and devices both paths take; raise ValueError. Lean:
    it runs on every launch."""
    if img.dim() != 4 or img.dtype not in DTYPES:
        raise ValueError(f"{name}: img must be (B, H, W, C) float32 or "
                         f"bfloat16, got {img.dtype} {tuple(img.shape)}")
    for t in floats:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: positions, matrices and depths must "
                             f"be float32, got {t.dtype}")
    if keep is not None and keep.dtype != torch.bool:
        raise ValueError(f"{name}: keep must be bool, got {keep.dtype}")
    cuda, index = img.is_cuda, img.get_device()
    for t in (img, *floats) if keep is None else (img, *floats, keep):
        if not (t.is_cuda and t.get_device() == index if cuda else t.is_cpu):
            raise ValueError(f"{name}: inputs must share one cpu or cuda "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def warp_sample(img, ref_to_src, depth, min_depth_thres: float = 0.001):
    """Plane-sweep sample: ``img`` warped over the depth hypotheses.

    :param img: (B, H, W, C) float32 or bfloat16, contiguous (the source
        view's features)
    :param ref_to_src: (B, 3, 4) float32 ref pixel -> src pixel projection
        (rows 0-2 of K_src [R|t]_src^-1 [R|t]_ref K_ref^-1)
    :param depth: (B, D, H, W) float32 depth hypotheses of the reference
    :param min_depth_thres: samples whose source z is below it are zero
    :return: (B, D, H, W, C) of img's dtype
    """
    _check("warp_sample", img, (ref_to_src, depth))
    B, H, W, C = img.shape
    if ref_to_src.shape != (B, 3, 4) or depth.dim() != 4 \
            or depth.shape[0] != B or depth.shape[2:] != (H, W):
        raise ValueError(f"warp_sample: want ref_to_src ({B}, 3, 4) and "
                         f"depth ({B}, D, {H}, {W}), got "
                         f"{tuple(ref_to_src.shape)} {tuple(depth.shape)}")
    D = depth.shape[1]
    if not img.is_cuda:
        return warp_sample_plain(img, ref_to_src, depth, min_depth_thres)
    if B * D > MAX_PLANES or _too_large(H, W, C):
        raise ValueError(f"warp_sample: {B} x {D} planes of {H} x {W} x {C} "
                         "exceed the kernel's grid or offsets")
    out = img.new_empty((B, D, H, W, C))
    if out.numel() == 0:
        return out
    vec, rows, planes = _plan(B, D, H, W, C, img.element_size(),
                              img.data_ptr() % 16, img.get_device())
    launch("tandem_warp_sample", img.device, _SWEEP_ARGS.pack(
        img.data_ptr(), ref_to_src.data_ptr(), depth.data_ptr(),
        out.data_ptr(), B, D, H, W, C, vec, rows, planes,
        int(img.dtype == torch.bfloat16), min_depth_thres))
    warp_sample.launches += 1
    return out


def bilinear_sample(img, px, py, keep=None):
    """Sample ``img`` at given pixel positions.

    :param img: (B, H, W, C) float32 or bfloat16, contiguous
    :param px, py: (B, N) float32 pixel positions, contiguous
    :param keep: optional (B, N) bool, contiguous; False samples are zero
    :return: (B, N, C) of img's dtype
    """
    _check("bilinear_sample", img, (px, py), keep)
    B, H, W, C = img.shape
    if px.dim() != 2 or px.shape[0] != B or py.shape != px.shape \
            or (keep is not None and keep.shape != px.shape):
        raise ValueError(f"bilinear_sample: want px, py (and keep) of one "
                         f"({B}, N) shape, got {tuple(px.shape)} "
                         f"{tuple(py.shape)}")
    if not img.is_cuda:
        return bilinear_sample_plain(img, px, py, keep)
    N = px.shape[1]
    if B > MAX_PLANES or N >= MAX_VALUES - 256 or _too_large(H, W, C):
        raise ValueError(f"bilinear_sample: {B} x {N} samples of {H} x {W} "
                         f"x {C} exceed the kernel's grid or offsets")
    out = img.new_empty((B, N, C))
    if out.numel() == 0:
        return out
    vec = _vec(C, img.element_size(), img.data_ptr())
    launch("tandem_bilinear_sample", img.device, _SAMPLE_ARGS.pack(
        img.data_ptr(), px.data_ptr(), py.data_ptr(),
        0 if keep is None else keep.data_ptr(), out.data_ptr(), B, N, H, W,
        C, vec, int(img.dtype == torch.bfloat16), 0))
    bilinear_sample.launches += 1
    return out


warp_sample.launches = 0
bilinear_sample.launches = 0
