"""FeatureNet: 3-scale 2D feature pyramid (FPN), NCHW.

The plain path of ``tandem_tpu/models/feature_net.py`` (parity target
cva_mvsnet/models/module.py:435-531): conv0 3x3 x2, conv1 5x5s2+3x3+3x3,
conv2 5x5s2+3x3+3x3, nearest 2x upsampling with 1x1 skip convs, output
convs stage1 1x1 / stage2,3 3x3 (no bias). Outputs {stage1: 4b, stage2: 2b,
stage3: b} channels at scales {1/4, 1/2, 1}. Module names follow the
reference so the converted state_dict loads as is. Everything runs in the
compute ``dtype``, the input cast once on entry (JAX cva_mvsnet.py:92);
``train=True`` gives the convolution blocks training BatchNorm
(``layers.batch_norm_train``), whose float32 outputs the next convolution
casts back, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from .layers import ConvBnRelu, conv_in, upsample_nearest_2x


class FeatureNet(nn.Module):
    def __init__(self, base_channels: int = 8, dtype=torch.float32):
        super().__init__()
        b = base_channels
        self.base_channels = b
        self.dtype = dtype
        kw = dict(dtype=dtype)
        self.conv0 = nn.Sequential(
            ConvBnRelu(3, b, 3, padding=1, **kw),
            ConvBnRelu(b, b, 3, padding=1, **kw))
        self.conv1 = nn.Sequential(
            ConvBnRelu(b, 2 * b, 5, stride=2, padding=2, **kw),
            ConvBnRelu(2 * b, 2 * b, 3, padding=1, **kw),
            ConvBnRelu(2 * b, 2 * b, 3, padding=1, **kw))
        self.conv2 = nn.Sequential(
            ConvBnRelu(2 * b, 4 * b, 5, stride=2, padding=2, **kw),
            ConvBnRelu(4 * b, 4 * b, 3, padding=1, **kw),
            ConvBnRelu(4 * b, 4 * b, 3, padding=1, **kw))
        self.out = nn.ModuleDict({
            "stage1": nn.Conv2d(4 * b, 4 * b, 1, bias=False),
            "stage2": nn.Conv2d(4 * b, 2 * b, 3, padding=1, bias=False),
            "stage3": nn.Conv2d(4 * b, b, 3, padding=1, bias=False)})
        self.skip = nn.ModuleDict({
            "stage2": nn.Conv2d(2 * b, 4 * b, 1, bias=True),
            "stage3": nn.Conv2d(b, 4 * b, 1, bias=True)})

    @property
    def out_channels(self) -> Dict[str, int]:
        b = self.base_channels
        return {"stage1": 4 * b, "stage2": 2 * b, "stage3": b}

    def forward(self, x, train: bool = False) -> Dict[str, "torch.Tensor"]:
        """:param x: (N, 3, H, W) -> {stage: (N, C_s, H/s, W/s)} in dtype"""
        dt = self.dtype

        def tower(blocks, x):
            for block in blocks:
                x = block(x, train)
            return x
        conv_s3 = tower(self.conv0, x.to(dt))
        conv_s2 = tower(self.conv1, conv_s3)
        conv_s1 = tower(self.conv2, conv_s2)
        inter2 = (upsample_nearest_2x(conv_s1)
                  + conv_in(self.skip["stage2"], conv_s2, dt))
        inter3 = (upsample_nearest_2x(inter2)
                  + conv_in(self.skip["stage3"], conv_s3, dt))
        return {"stage1": conv_in(self.out["stage1"], conv_s1, dt),
                "stage2": conv_in(self.out["stage2"], inter2, dt),
                "stage3": conv_in(self.out["stage3"], inter3, dt)}
