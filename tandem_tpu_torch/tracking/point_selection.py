"""Gradient-based candidate pixel selection.

Port of ``tandem_tpu/tracking/point_selection.py`` (DSO's PixelSelector2,
tandem/src/FullSystem/PixelSelector2.h:37, makeMaps): a per-block adaptive
gradient threshold (the block median + 7, smoothed 3x3), then the strongest
pixel of each potential cell where it clears the threshold. The result is
integer choices, so it equals the JAX package's exactly: the median is
``jnp.median``'s midpoint of the two middle values, and ties in a cell go
to the first pixel in raster order, as ``argmax`` takes them in both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.consts import const


def _edge_pad(x, pad):
    """``jnp.pad(x, pad, mode="edge")`` of a 2-D tensor; pad is
    (left, right, top, bottom)."""
    return F.pad(x[None, None], pad, mode="replicate")[0, 0]


def select_pixels(abs_grad2, block: int = 32, potential: int = 4,
                  threshold_factor: float = 1.0):
    """:param abs_grad2: (H, W) squared gradient magnitude
    :param block: adaptive-threshold region size (DSO: 32x32 histograms)
    :param potential: selection cell size (one point per cell at most)
    :return: (H, W) bool mask of the selected pixels."""
    H, W = abs_grad2.shape
    dev = abs_grad2.device
    g = torch.sqrt(abs_grad2)

    Hb, Wb = H // block, W // block
    gb = g[:Hb * block, :Wb * block].reshape(Hb, block, Wb, block)
    gb = gb.permute(0, 2, 1, 3).reshape(Hb, Wb, block * block)
    srt = torch.sort(gb, dim=-1).values
    n = block * block
    med = (srt[..., (n - 1) // 2] + srt[..., n // 2]) * 0.5
    th_block = (med + 7.0) * threshold_factor
    thp = _edge_pad(th_block, (1, 1, 1, 1))
    th_s = thp[0:Hb, 0:Wb]
    for dy in range(3):
        for dx in range(3):
            if dy or dx:
                th_s = th_s + thp[dy:dy + Hb, dx:dx + Wb]
    # A tensor divisor: CUDA turns ``x / 9.0`` into x times a rounded 1/9.
    th_s = th_s / const(9.0, dev)
    th_full = th_s.repeat_interleave(block, 0).repeat_interleave(block, 1)
    th_full = _edge_pad(th_full, (0, W - Wb * block, 0, H - Hb * block))

    Hp, Wp = H // potential, W // potential
    gc = g[:Hp * potential, :Wp * potential].reshape(
        Hp, potential, Wp, potential).permute(0, 2, 1, 3).reshape(
        Hp, Wp, potential * potential)
    best = torch.argmax(gc, dim=-1)
    best_val = torch.gather(gc, -1, best[..., None])[..., 0]
    keep = best_val > th_full[::potential, ::potential][:Hp, :Wp]

    ys = torch.arange(Hp, device=dev)[:, None] * potential + best // potential
    xs = torch.arange(Wp, device=dev)[None, :] * potential + best % potential
    flat = torch.where(keep, ys * W + xs, torch.full_like(ys, H * W))
    mask = torch.zeros(H * W + 1, dtype=torch.bool, device=dev)
    mask.index_fill_(0, flat.reshape(-1), True)   # slot H*W is cut off
    mask = mask[:H * W].reshape(H, W)
    border = torch.zeros((H, W), dtype=torch.bool, device=dev)
    border[3:-3, 3:-3] = True
    return mask & border
