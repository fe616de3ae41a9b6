"""Coarse distance map for spatially spread point activation.

Port of ``tandem_tpu/tracking/distance_map.py`` (the reference's
CoarseDistanceMap, tandem/src/FullSystem/CoarseTracker.h:168-212,
makeDistanceMap/growDistBFS CoarseTracker.cpp:1253,1294): a BFS distance
transform over the projected active points, used to prefer candidates far
from existing points. The BFS is an iterated 4-neighbour min-plus
relaxation (the L1 distance transform), torch ops on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch


def distance_map(occupied, max_dist: int = 40):
    """:param occupied: (H, W) bool tensor, pixels holding an active point
    :return: (H, W) int32 L1 distance to the nearest occupied pixel,
        clamped at max_dist."""
    d = torch.where(occupied, 0, max_dist).to(torch.int32)
    for _ in range(max_dist):
        up = torch.cat([d[1:], d[-1:]], 0)
        down = torch.cat([d[:1], d[:-1]], 0)
        left = torch.cat([d[:, 1:], d[:, -1:]], 1)
        right = torch.cat([d[:, :1], d[:, :-1]], 1)
        nbr = torch.minimum(torch.minimum(up, down),
                            torch.minimum(left, right))
        d = torch.minimum(d, nbr + 1)
    return d


def select_spread(candidate_mask, occupied, want: int, max_dist: int = 40):
    """Pick up to ``want`` candidates, preferring a large distance from the
    existing points (activatePointsMT's spacing, FullSystem.cpp:706-).
    :return: (n, 2) int32 numpy (x, y)."""
    d = distance_map(torch.as_tensor(occupied), max_dist).cpu().numpy()
    ys, xs = np.nonzero(torch.as_tensor(candidate_mask).cpu().numpy())
    if len(ys) == 0:
        return np.zeros((0, 2), np.int32)
    scores = d[ys, xs]
    order = np.argsort(-scores, kind="stable")[:want]
    return np.stack([xs[order], ys[order]], -1).astype(np.int32)
