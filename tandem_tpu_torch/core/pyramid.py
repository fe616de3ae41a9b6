"""Image pyramids with gradients.

Port of ``tandem_tpu/core/pyramid.py`` (FrameHessian::makeImages,
tandem/src/FullSystem/HessianBlocks.h:322): level l+1 is the 2x2 average of
level l; gradients are central differences, zero on the 1-pixel border. All
tensors are (H, W) float32; the pyramid is a list ordered fine -> coarse.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def downsample_2x2(img: torch.Tensor) -> torch.Tensor:
    """2x2 average; odd trailing row/col dropped (DSO's w >> l sizing)."""
    H, W = img.shape
    H2, W2 = H // 2, W // 2
    return img[:H2 * 2, :W2 * 2].reshape(H2, 2, W2, 2).mean(dim=(1, 3))


def gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients, zero on the 1-pixel border."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def build_pyramid(img: torch.Tensor, num_levels: int = 6) -> List[dict]:
    """:param img: (H, W) float32 intensity in [0, 255]
    :return: list of {'img', 'gx', 'gy', 'abs_grad2'} fine -> coarse."""
    levels = []
    cur = img
    for lvl in range(num_levels):
        gx, gy = gradients(cur)
        levels.append({"img": cur, "gx": gx, "gy": gy,
                       "abs_grad2": gx * gx + gy * gy})
        if lvl + 1 < num_levels:
            cur = downsample_2x2(cur)
    return levels


def pyramid_intrinsics(fx, fy, cx, cy, num_levels: int = 6):
    """DSO's per-level calibration (tandem/src/util/globalCalib.cpp:32-44):
    fx_l = fx * 2^-l, cx_l = (cx + 0.5) * 2^-l - 0.5 (the half-pixel
    convention)."""
    out = []
    for lvl in range(num_levels):
        s = 0.5 ** lvl
        out.append((fx * s, fy * s, (cx + 0.5) * s - 0.5,
                    (cy + 0.5) * s - 0.5))
    return out
