"""Depth-discontinuity edge filter.

Port of ``tandem_tpu/models/edge_filter.py`` (parity target
depth_filter_edges, cva_mvsnet/models/module.py:1320-1361): per pixel the
15th smallest absolute depth difference within a zero-padded 5x5 window
(kernel K1), then the strongest ``discard_percentage``% pixels of each
batch element are zeroed (threshold = the per-image k-th value of the edge
image). The whole filter is one op, ``ops/edge_kth.edge_filter``: on the
card one memset and four kernel launches, with no host read.
"""

from __future__ import annotations

import torch

from ..ops.edge_kth import edge_filter


def _cutoff(discard_percentage, hw: int) -> list:
    """Threshold rank per image, in float32 exactly as the JAX package
    computes it (so the rank never shifts by one): trunc(H*W*(100-p)/100)
    clipped to [0, H*W-1]. Computed on the host: the ranks are the op's
    arguments, passed by value."""
    p = torch.as_tensor(discard_percentage).detach().to("cpu", torch.float32)
    cutoff = (hw * (100.0 - p) / 100.0).to(torch.int32)
    return torch.clamp(cutoff, 0, hw - 1).tolist()


def filter_edges(depth, discard_percentage, conf=None):
    """5x5 window (the only one the model uses).

    :param depth: (B, H, W) float32
    :param discard_percentage: (B,) percentage in [0, 100] (any device; a
        CPU tensor avoids a device sync)
    :param conf: None or (B, H, W) float32, zeroed where depth is
    :return: ``EdgeFiltered(depth, conf, mask, threshold)``; mask True =
        discarded"""
    H, W = depth.shape[1:]
    return edge_filter(depth.contiguous(),
                       _cutoff(discard_percentage, H * W),
                       None if conf is None else conf.contiguous())


def depth_filter_edges(depth, discard_percentage):
    """The JAX package's signature: filtered depth (B, H, W), mask (B, H, W)
    bool (True = discarded)."""
    out = filter_edges(depth, discard_percentage)
    return out.depth, out.mask
