"""Depth-discontinuity edge filter.

Port of ``tandem_tpu/models/edge_filter.py`` (parity target
depth_filter_edges, cva_mvsnet/models/module.py:1320-1361): per pixel the
15th smallest absolute depth difference within a zero-padded 5x5 window
(kernel K1), then the strongest ``discard_percentage``% pixels of each
batch element are zeroed (threshold = the per-image k-th value of the edge
image). The whole filter is one custom op, ``tandem::edge_filter``
(``ops/edge_kth.py``): on the card one memset and four kernel launches,
with no device sync when the percentage lies on the CPU.
"""

from __future__ import annotations

import torch

from ..ops.edge_kth import EdgeFiltered


def filter_edges(depth, discard_percentage, conf=None):
    """5x5 window (the only one the model uses).

    :param depth: (B, H, W) float32
    :param discard_percentage: (B,) percentage in [0, 100], a tensor on any
        device or numbers (a CPU tensor avoids a device sync)
    :param conf: None or (B, H, W) float32, zeroed where depth is
    :return: ``EdgeFiltered(depth, conf, mask, threshold)``; mask True =
        discarded"""
    fdepth, fconf, mask, thres = torch.ops.tandem.edge_filter(
        depth.contiguous(),
        torch.as_tensor(discard_percentage, dtype=torch.float32),
        None if conf is None else conf.contiguous())
    return EdgeFiltered(fdepth, None if conf is None else fconf, mask, thres)


def depth_filter_edges(depth, discard_percentage):
    """The JAX package's signature: filtered depth (B, H, W), mask (B, H, W)
    bool (True = discarded)."""
    out = filter_edges(depth, discard_percentage)
    return out.depth, out.mask
