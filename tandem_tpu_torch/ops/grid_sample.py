"""Per-corner zero-padded bilinear sampling (grid_sample semantics).

Matches torch.nn.functional.grid_sample(mode='bilinear',
padding_mode='zeros', align_corners=True) in pixel coordinates, which the
reference plane-sweep warp depends on (cva_mvsnet/models/module.py:782-789,
871-873). Explicit indexing into a 1-pixel zero-padded row table replaces
grid_sample's normalise/denormalise round trip, so the arithmetic is the one
``tandem_tpu/ops/grid_sample.py`` and ``ops/warp.py`` use: each corner
outside the image reads the zero pad, and a cell whose floor lies beyond
the pad contributes exactly zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_corners(x, y, H: int, W: int, keep=None):
    """Floor cell and four corner weights of pixel positions x, y.

    :param keep: optional bool mask folded into the weights (samples with
        keep=False contribute zero).
    :return: xi, yi (int64 base index into the 1-padded image, in [0, W] /
        [0, H]) and weights (w00, w10, w01, w11) in the corner order
        (y, x), (y, x+1), (y+1, x), (y+1, x+1).
    """
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = x - x0
    wy1 = y - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    inside = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    if keep is not None:
        inside = inside & keep
    ins = inside.to(x.dtype)
    weights = (wx0 * wy0 * ins, wx1 * wy0 * ins, wx0 * wy1 * ins,
               wx1 * wy1 * ins)
    xi = torch.clamp(x0, -1, W - 1).long() + 1
    yi = torch.clamp(y0, -1, H - 1).long() + 1
    return xi, yi, weights


def sample_corners(img, xi, yi, weights):
    """Blend the four corners of each cell.

    :param img: (B, H, W, C); xi, yi, weights: (B, ...) from
        ``bilinear_corners``
    :return: (B, ..., C)
    """
    B, H, W, C = img.shape
    Wp = W + 2
    table = F.pad(img, (0, 0, 1, 1, 1, 1)).reshape(B * (H + 2) * Wp, C)
    offs = torch.arange(B, device=img.device) * ((H + 2) * Wp)
    base = yi * Wp + xi + offs.reshape((B,) + (1,) * (yi.dim() - 1))
    w00, w10, w01, w11 = (w.unsqueeze(-1).to(img.dtype) for w in weights)
    return (table[base] * w00 + table[base + 1] * w10
            + table[base + Wp] * w01 + table[base + Wp + 1] * w11)
