"""CostRegNet (4-level 3D U-Net, NCDHW) and the view-aggregation gate.

Plain path of ``tandem_tpu/models/cost_reg.py`` (parity target
cva_mvsnet/models/module.py:534-600): stride-2 encoder, except stride
(1, 2, 2) and output_padding (0, 1, 1) at the deepest level when D == 4;
ConvTranspose3d decoder with skip additions (each decoder step adds its
skip itself: one kernel launch a step in eval on the card,
``ops/deconv3d.py``); a 3x3x3 single-channel logit conv without bias.
Both modules compute in their ``dtype`` (float32 or bfloat16) from the
float32 parameters, as the JAX modules do, and take ``train=True`` for
training BatchNorm (``layers.batch_norm_train``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BN_EPS, ConvBnRelu, DeconvBnRelu, batch_norm_train,
                     conv_in, fold_bn)


class CostRegNet(nn.Module):
    def __init__(self, in_channels: int, base_channels: int = 8,
                 has_four_depths: bool = False, dtype=torch.float32):
        super().__init__()
        b = base_channels
        s5 = (1, 2, 2) if has_four_depths else 2
        op5 = (0, 1, 1) if has_four_depths else 1
        self.dtype = dtype
        kw = dict(ndim=3, padding=1, dtype=dtype)
        self.conv0 = ConvBnRelu(in_channels, b, 3, **kw)
        self.conv1 = ConvBnRelu(b, 2 * b, 3, stride=2, **kw)
        self.conv2 = ConvBnRelu(2 * b, 2 * b, 3, **kw)
        self.conv3 = ConvBnRelu(2 * b, 4 * b, 3, stride=2, **kw)
        self.conv4 = ConvBnRelu(4 * b, 4 * b, 3, **kw)
        self.conv5 = ConvBnRelu(4 * b, 8 * b, 3, stride=s5, **kw)
        self.conv6 = ConvBnRelu(8 * b, 8 * b, 3, **kw)
        self.conv7 = DeconvBnRelu(8 * b, 4 * b, stride=s5,
                                  output_padding=op5, dtype=dtype)
        self.conv9 = DeconvBnRelu(4 * b, 2 * b, dtype=dtype)
        self.conv11 = DeconvBnRelu(2 * b, b, dtype=dtype)
        self.prob = nn.Conv3d(b, 1, 3, padding=1, bias=False)

    def forward(self, x, train: bool = False):
        """:param x: (B, C, D, H, W) cost volume -> logits (B, D, H, W) in
        dtype"""
        t = train
        conv0 = self.conv0(x, t)
        conv2 = self.conv2(self.conv1(conv0, t), t)
        conv4 = self.conv4(self.conv3(conv2, t), t)
        x = self.conv6(self.conv5(conv4, t), t)
        x = self.conv7(x, t, skip=conv4)
        x = self.conv9(x, t, skip=conv2)
        x = self.conv11(x, t, skip=conv0)
        return conv_in(self.prob, x, self.dtype)[:, 0]


class VolumeGate(nn.Sequential):
    """Self-adaptive view-aggregation gate: Conv3d(C->1, 1x1x1)+BN+ReLU then
    Conv3d(1->1, 1x1x1)+BN+ReLU (cva_mvsnet/models/cva_mvsnet.py:76-83).

    The parameters sit in the reference's Sequential layout (keys 0, 1, 3,
    4); the eval forward is the C-contraction plus scalar affine maps of
    ``tandem_tpu``'s VolumeGate eval path, on channels-last input, so the
    cost volume never leaves its (B, D, H, W, C) layout per view."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__(
            nn.Conv3d(channels, 1, 1, bias=True),
            nn.BatchNorm3d(1, eps=BN_EPS), nn.ReLU(),
            nn.Conv3d(1, 1, 1, bias=True),
            nn.BatchNorm3d(1, eps=BN_EPS), nn.ReLU())
        self.dtype = dtype

    def forward(self, x, train: bool = False):
        """:param x: (B, D, H, W, C) -> (B, D, H, W) in dtype (JAX
        cost_reg.py:111-121: weights and biases cast to the compute dtype,
        BatchNorm folded); with ``train``, float32 after each training
        BatchNorm over all of (B, D, H, W) (JAX cost_reg.py:100-109), which
        updates the running statistics once a call: once a source view."""
        c0, bn0, _, c1, bn1, _ = self
        dt = self.dtype
        y = F.linear(x.to(dt), c0.weight.to(dt).reshape(1, -1),
                     c0.bias.to(dt))[..., 0]
        if train:
            y = F.relu(batch_norm_train(y.reshape(1, 1, -1), bn0)).to(dt)
            y = y * c1.weight.to(dt).reshape(()) + c1.bias.to(dt)
            y = F.relu(batch_norm_train(y, bn1))
            return y.reshape(x.shape[:-1])
        inv0, off0 = fold_bn(bn0, dt)                       # (1,) each
        inv1, off1 = fold_bn(bn1, dt)
        y = F.relu(y * inv0 + off0)
        y = y * c1.weight.to(dt).reshape(()) + c1.bias.to(dt)
        return F.relu(y * inv1 + off1)
