"""Depth-discontinuity edge filter.

Port of ``tandem_tpu/models/edge_filter.py`` (parity target
depth_filter_edges, cva_mvsnet/models/module.py:1320-1361): per pixel the
15th smallest absolute depth difference within a zero-padded 5x5 window
(kernel K1, ops/edge_kth.py), then the strongest ``discard_percentage``%
pixels of each batch element are zeroed (threshold = the per-image k-th
value of the edge image).
"""

from __future__ import annotations

import torch

from ..ops.edge_kth import edge_kth_value


def _cutoff(discard_percentage, hw: int) -> list:
    """Threshold rank per image, in float32 exactly as the JAX package
    computes it (so the rank never shifts by one): trunc(H*W*(100-p)/100)
    clipped to [0, H*W-1]. Computed on the host: the ranks size kthvalue."""
    p = torch.as_tensor(discard_percentage).detach().to("cpu", torch.float32)
    cutoff = (hw * (100.0 - p) / 100.0).to(torch.int32)
    return torch.clamp(cutoff, 0, hw - 1).tolist()


def depth_filter_edges(depth, discard_percentage):
    """5x5 window (the only one the model uses).

    :param depth: (B, H, W) float32
    :param discard_percentage: (B,) percentage in [0, 100] (any device; a
        CPU tensor avoids a device sync)
    :return: filtered depth (B, H, W), mask (B, H, W) bool (True = discarded)
    """
    B, H, W = depth.shape
    edge = edge_kth_value(depth.contiguous())
    edge_flat = edge.reshape(B, H * W)
    # k-th smallest per image (0-indexed k == sort(x)[k]): kthvalue is
    # 1-indexed.
    thres = torch.stack([torch.kthvalue(edge_flat[b], k + 1).values
                         for b, k in enumerate(_cutoff(discard_percentage,
                                                       H * W))])
    mask = edge > thres[:, None, None]
    return torch.where(mask, torch.zeros_like(depth), depth), mask
