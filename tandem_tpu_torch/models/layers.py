"""Conv/Deconv + BatchNorm + ReLU building blocks (NCHW / NCDHW).

Plain semantics of ``tandem_tpu/models/layers.py`` (the reference wrappers,
cva_mvsnet/models/module.py:64-284): conv bias only when normalization is
disabled, eval BatchNorm with eps 1e-5, and the transposed conv as torch's
own ``ConvTranspose3d`` with output_padding. The JAX package's folded,
patched and banded conv layouts are TPU layout tricks with the same math;
they have no counterpart here.

Two modes, chosen by the ``train`` argument of ``forward`` (never by
``nn.Module.training``, so a model nobody put in eval mode still serves):
eval (the default) folds BatchNorm as below; train normalizes with the
batch's statistics and updates the running ones as flax's
``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=float32)`` does
(``batch_norm_train``).

Compute dtype (float32 or bfloat16, the JAX package's ``dtype``): the
parameters stay float32 (one copy, the converted state_dict) and are cast
to the compute dtype where they are used; convolutions run in that dtype
(cuDNN accumulates in float32, and so does the eval decoder step's kernel
on the card, ``ops/deconv3d.py``). Eval BatchNorm is the folded form of
JAX ``_EvalFoldedBN``: scale and offset computed in float32 on the (C,)
vectors, cast to the compute dtype, applied as ``x * inv + off``. Train
BatchNorm computes and returns float32, as flax's does.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.deconv3d import deconv_bn_relu_add
from ..parallel import collectives

BN_EPS = 1e-5
BN_MOMENTUM = 0.9


def fold_bn(bn: nn.modules.batchnorm._BatchNorm, dtype):
    """Eval BatchNorm as a per-channel (inv, off) pair in ``dtype``."""
    inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
    off = bn.bias - bn.running_mean * inv
    return inv.to(dtype), off.to(dtype)


def apply_bn(x, bn, dtype):
    """Folded eval BatchNorm on channel axis 1 of x."""
    inv, off = fold_bn(bn, dtype)
    shape = (-1,) + (1,) * (x.dim() - 2)
    return x * inv.reshape(shape) + off.reshape(shape)


class _SumOverRanks(torch.autograd.Function):
    """A sum over the ranks of the default process group whose gradient
    is the sum of the ranks' gradients: every rank's loss reads the summed
    value, so each rank's input feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x):
        return collectives.all_reduce_sum(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return collectives.all_reduce_sum(grad.clone())


def batch_norm_train(x, bn):
    """flax's training BatchNorm (``use_fast_variance=True``) on channel
    axis 1 of x, in float32: the batch mean and the biased variance
    E[x^2] - E[x]^2 (clipped at 0), y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias; ``bn``'s running statistics become
    0.9 * running + 0.1 * batch (torch's own update would use the
    unbiased variance and weigh the batch by its ``momentum``).

    Under a process group (data-parallel training) the statistics are
    the global batch's, as in the JAX package's sharded step: each
    channel's sums of x and x^2 and the element count are summed over the
    ranks (one all-reduce, differentiable), so every rank normalizes with,
    and keeps, the same statistics."""
    xf = x.float()
    dims = [0] + list(range(2, x.dim()))
    if collectives.in_group():
        count = torch.full((1,), xf.numel() / xf.shape[1],
                           device=xf.device)
        sums = _SumOverRanks.apply(torch.cat([xf.sum(dims),
                                              (xf * xf).sum(dims), count]))
        C = xf.shape[1]
        mean, mean2 = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
    else:
        mean = xf.mean(dims)
        mean2 = (xf * xf).mean(dims)
    var = torch.clamp(mean2 - mean * mean, min=0.0)
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                              + (1 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                             + (1 - BN_MOMENTUM) * var)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (xf - mean.reshape(shape)) * mul.reshape(shape) \
        + bn.bias.reshape(shape)


def conv_in(conv, x, dtype):
    """Run torch conv module ``conv`` on x with input, weight and bias cast
    to ``dtype``."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return conv._conv_forward(x.to(dtype), conv.weight.to(dtype), bias)


class ConvBnRelu(nn.Module):
    """Conv (2D or 3D) without bias + BatchNorm + optional ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel, ndim: int = 2,
                 stride=1, padding=0, relu: bool = True,
                 dtype=torch.float32):
        super().__init__()
        conv = nn.Conv2d if ndim == 2 else nn.Conv3d
        bn = nn.BatchNorm2d if ndim == 2 else nn.BatchNorm3d
        self.conv = conv(in_ch, out_ch, kernel, stride=stride,
                         padding=padding, bias=False)
        self.bn = bn(out_ch, eps=BN_EPS)
        self.relu = relu
        self.dtype = dtype

    def forward(self, x, train: bool = False):
        x = conv_in(self.conv, x, self.dtype)
        x = batch_norm_train(x, self.bn) if train else \
            apply_bn(x, self.bn, self.dtype)
        return F.relu(x) if self.relu else x


class DeconvBnRelu(nn.Module):
    """torch ConvTranspose3d (kernel 3, padding 1) + BatchNorm + ReLU, and
    the decoder's skip added last when one is given.

    The eval forward on the card, where no autograd graph is recorded, is
    one launch of the hand-written kernel ``ops/deconv3d.py`` (the
    convolution gathered by phase, the folded BatchNorm, the ReLU and the
    skip); training, a forward that records a graph and CPU tensors run
    ``F.conv_transpose3d`` and the BatchNorm, ReLU and skip as torch ops."""

    def __init__(self, in_ch: int, out_ch: int, stride=2, output_padding=1,
                 relu: bool = True, dtype=torch.float32):
        super().__init__()
        self.conv = nn.ConvTranspose3d(in_ch, out_ch, 3, stride=stride,
                                       padding=1,
                                       output_padding=output_padding,
                                       bias=False)
        self.bn = nn.BatchNorm3d(out_ch, eps=BN_EPS)
        self.relu = relu
        self.dtype = dtype

    def forward(self, x, train: bool = False, skip=None):
        c, dt = self.conv, self.dtype
        if not train and x.is_cuda and not _records_graph(
                x, skip, c.weight, self.bn.weight, self.bn.bias):
            inv, off = fold_bn(self.bn, dt)
            return deconv_bn_relu_add(x.to(dt), c.weight.to(dt), inv, off,
                                      skip, c.stride, self.relu)
        x = F.conv_transpose3d(x.to(dt), c.weight.to(dt), None, c.stride,
                               c.padding, c.output_padding)
        x = batch_norm_train(x, self.bn) if train else apply_bn(x, self.bn,
                                                                dt)
        x = F.relu(x) if self.relu else x
        return x if skip is None else skip + x


def _records_graph(*tensors) -> bool:
    """Whether autograd records a graph of an op on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


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
