"""Zero-padded bilinear sampling (grid_sample semantics) through the
packed-corner table.

Port of ``tandem_tpu/ops/grid_sample.py``. Matches
torch.nn.functional.grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=True) in pixel coordinates, which the reference plane-sweep
warp depends on (cva_mvsnet/models/module.py:782-789, 871-873). The four
corners of every cell sit side by side in one row of a table built from a
1-pixel zero-padded copy of the image (``pack_corners``), so a sample is
one row read: kernel P5 (``ops/bilinear_index.py``) turns positions into
rows and weights, kernel P3 (``ops/corner_blend.py``) reads and blends the
rows. Each corner outside the image reads the zero pad, and a cell whose
floor lies beyond the pad contributes exactly zero.
"""

from __future__ import annotations

import torch.nn.functional as F
import torch

from .bilinear_index import bilinear_index, table_rows
from .corner_blend import corner_blend


def pack_corners(img):
    """(B, H, W, C) -> (B, H+1, W+1, 4C) zero-padded corner table.

    Row (y, x) holds [v(y,x), v(y,x+1), v(y+1,x), v(y+1,x+1)] of the padded
    image, so row (y0+1, x0+1) holds all four corners of the cell whose
    top-left is (y0, x0) in image coordinates, for y0, x0 in
    [-1, H-1] x [-1, W-1]."""
    p = F.pad(img, (0, 0, 1, 1, 1, 1))
    return torch.cat([p[:, :-1, :-1], p[:, :-1, 1:],
                      p[:, 1:, :-1], p[:, 1:, 1:]], -1)


def sample_packed(img, px, py, keep=None):
    """Sample ``img`` (B, H, W, C) at float32 pixel positions px, py of
    shape (B, ...), with samples whose ``keep`` is False set to zero.

    The weights are cast to img's dtype (as the JAX package does) and the
    blend is summed in float32. Returns (B, ..., C) of img's dtype."""
    B, H, W, C = img.shape
    rows, weights = bilinear_index(px, py, H, W, keep=keep, batches=B,
                                   dtype=img.dtype)
    table = pack_corners(img).reshape(B * table_rows(H, W), 4 * C)
    out = corner_blend(table, rows.reshape(-1), weights.reshape(4, -1))
    return out.reshape(*px.shape, C)


def bilinear_sample_pixel(img, x, y):
    """Sample ``img`` (B, H, W, C) at pixel coordinates x, y (B, N) with
    bilinear interpolation and per-corner zero padding outside
    [0, W-1] x [0, H-1]. Returns (B, N, C)."""
    return sample_packed(img, x.float().contiguous(), y.float().contiguous())


def grid_sample_bilinear(img, grid):
    """torch-compatible grid_sample.

    :param img: (B, H, W, C)
    :param grid: (B, Ho, Wo, 2) normalized coords in [-1, 1], align_corners
        convention: -1 -> pixel 0, +1 -> pixel (W-1) (module.py:782-789)
    :return: (B, Ho, Wo, C)
    """
    B, H, W, C = img.shape
    _, Ho, Wo, _ = grid.shape
    x = (grid[..., 0].float() + 1.0) * (0.5 * (W - 1))
    y = (grid[..., 1].float() + 1.0) * (0.5 * (H - 1))
    out = bilinear_sample_pixel(img, x.reshape(B, -1), y.reshape(B, -1))
    return out.reshape(B, Ho, Wo, C)
