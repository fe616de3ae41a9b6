"""Depth-hypothesis range sampling for the cascade.

Port of ``tandem_tpu/models/ranges.py`` (parity targets uniform_depth_range,
cva_mvsnet/models/module.py:1480-1500, and adaptive_depth_range,
module.py:1503-1565).
"""

from __future__ import annotations

import torch


def uniform_depth_range(*, depth_min, depth_max, depth_num: int, height: int,
                        width: int):
    """:param depth_min, depth_max: (B,) tensors
    :return: (B, D, H, W) samples and (B,) base interval."""
    depth_min = depth_min.float()
    depth_max = depth_max.float()
    interval = (depth_max - depth_min) / (depth_num - 1)
    steps = torch.arange(depth_num, dtype=torch.float32,
                         device=depth_min.device)
    depth = depth_min[:, None] + interval[:, None] * steps[None, :]
    depth = depth[:, :, None, None].expand(*depth.shape, height, width)
    return depth, interval


def adaptive_depth_range(*, depth, interval, depth_num: int,
                         depth_clamp_min: float = 0.001,
                         inverse_depth: bool = False):
    """Window of ``depth_num`` hypotheses around a previous-stage depth map.

    :param depth: (B, H, W) upsampled previous-stage depth
    :param interval: (B,) this stage's interval (base_interval * ratio)
    :return: (B, D, H, W)
    """
    depth_min = depth - (depth_num / 2.0) * interval[:, None, None]
    depth_min = torch.clamp(depth_min, min=depth_clamp_min)
    depth_max = depth_min + depth_num * interval[:, None, None]
    dev = depth.device

    if not inverse_depth:
        # linspace(0, 1, D+1)[:-1] == arange(D)/D  (module.py:1528-1530)
        lin = torch.arange(depth_num, dtype=torch.float32, device=dev) \
            / depth_num
    else:
        # Non-uniform spacing concentrated near the centre
        # (module.py:1547-1559).
        f = {32: 0.5, 8: 0.3}[depth_num]
        half = (1.0 / torch.linspace(1.0 / f, 1.0, depth_num // 2,
                                     device=dev) - f) / (1.0 - f)
        half = (half + 0.5 * half[1]) / (1.0 + 0.5 * half[1])
        lin = 0.5 * torch.cat([-half.flip(0), half]) + 0.5
    lin = lin.reshape(1, -1, 1, 1)
    return depth_min[:, None] + (depth_max - depth_min)[:, None] * lin
