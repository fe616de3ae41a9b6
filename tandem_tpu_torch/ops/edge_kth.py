"""Kernel K1: the edge filter's per-pixel 5x5 k-th absolute difference.

``edge_kth_value`` launches the hand-written CUDA kernel
``csrc/edge_kth.cu`` (the port of ``tandem_tpu/ops/pallas_kernels.py``
``edge_kth_value_pallas``) for CUDA tensors and uses ``edge_kth_plain`` for
CPU tensors. There is no fallback: a CUDA tensor goes through the kernel
or the call raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

WINDOW = 5
K_RANK = WINDOW * (WINDOW // 2 + 1)  # 15 of 25 (module.py:1338-1339)


def edge_kth_plain(depth):
    """Unfold + sort form of ``edge_kth_value_xla``.

    :param depth: (B, H, W) float32 -> (B, H, W) float32: the K_RANK-th
        smallest |d(y+dy, x+dx) - d(y, x)| over the zero-padded window."""
    B, H, W = depth.shape
    w2 = WINDOW // 2
    padded = F.pad(depth, (w2, w2, w2, w2))
    shifts = torch.stack([padded[:, dy:dy + H, dx:dx + W]
                          for dy in range(WINDOW) for dx in range(WINDOW)], -1)
    edge = (shifts - depth[..., None]).abs()
    return torch.sort(edge, dim=-1).values[..., K_RANK - 1]


def edge_kth_value(depth):
    """:param depth: (B, H, W) float32 contiguous -> (B, H, W) float32."""
    if depth.device.type == "cpu":
        return edge_kth_plain(depth)
    if depth.device.type != "cuda":
        raise ValueError(f"edge_kth_value: unsupported device {depth.device}")
    if depth.dtype != torch.float32 or depth.dim() != 3:
        raise ValueError("edge_kth_value: expected a (B, H, W) float32 "
                         f"tensor, got {tuple(depth.shape)} {depth.dtype}")
    if not depth.is_contiguous():
        raise ValueError("edge_kth_value: depth must be contiguous")
    from ._build import launch

    B, H, W = depth.shape
    out = torch.empty_like(depth)
    if depth.numel() == 0:
        return out
    launch("tandem_edge_kth", depth.device, depth.data_ptr(), out.data_ptr(),
           B, H, W)
    edge_kth_value.launches += 1
    return out


edge_kth_value.launches = 0
