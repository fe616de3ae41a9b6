"""Conv/Deconv + BatchNorm + ReLU building blocks (NCHW / NCDHW).

Plain semantics of ``tandem_tpu/models/layers.py`` (the reference wrappers,
cva_mvsnet/models/module.py:64-284): conv bias only when normalization is
disabled, eval BatchNorm with eps 1e-5, and the transposed conv as torch's
own ``ConvTranspose3d`` with output_padding. The JAX package's folded,
patched and banded conv layouts are TPU layout tricks with the same math;
they have no counterpart here. The modules are inference modules: callers
keep them in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

BN_EPS = 1e-5


class ConvBnRelu(nn.Module):
    """Conv (2D or 3D) without bias + eval BatchNorm + optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel, ndim: int = 2,
                 stride=1, padding=0, relu: bool = True):
        super().__init__()
        conv = nn.Conv2d if ndim == 2 else nn.Conv3d
        bn = nn.BatchNorm2d if ndim == 2 else nn.BatchNorm3d
        self.conv = conv(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, bias=False)
        self.bn = bn(out_ch, eps=BN_EPS)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class DeconvBnRelu(nn.Module):
    """torch ConvTranspose3d (kernel 3, padding 1) + BatchNorm + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, stride=2, output_padding=1,
                 relu: bool = True):
        super().__init__()
        self.conv = nn.ConvTranspose3d(in_ch, out_ch, 3, stride=stride,
                                       padding=1,
                                       output_padding=output_padding,
                                       bias=False)
        self.bn = nn.BatchNorm3d(out_ch, eps=BN_EPS)
        self.relu = relu

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsample of NCHW input."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def interpolate_bilinear(x, out_h: int, out_w: int):
    """torch F.interpolate(mode='bilinear', align_corners=False) semantics
    on NHWC input, with the source coordinates clamped to [0, H-1] x
    [0, W-1] exactly as ``tandem_tpu.models.layers.interpolate_bilinear``
    computes them (the cascade's only use).

    :param x: (B, H, W, C)
    """
    B, H, W, C = x.shape
    dev = x.device
    ys = ((torch.arange(out_h, device=dev) + 0.5) * (H / out_h) - 0.5
          ).clamp(0, H - 1)
    xs = ((torch.arange(out_w, device=dev) + 0.5) * (W / out_w) - 0.5
          ).clamp(0, W - 1)
    y0 = torch.floor(ys).long()
    x0 = torch.floor(xs).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = (ys - y0).to(x.dtype)[None, :, None, None]
    wx = (xs - x0).to(x.dtype)[None, None, :, None]
    r0, r1 = x[:, y0], x[:, y1]
    top = r0[:, :, x0] * (1 - wx) + r0[:, :, x1] * wx
    bot = r1[:, :, x0] * (1 - wx) + r1[:, :, x1] * wx
    return top * (1 - wy) + bot * wy
