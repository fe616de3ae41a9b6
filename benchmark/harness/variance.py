"""The work of the variance cost volume's step (``warp_variance``: one
source view's plane-sweep samples added to the running sum and sum of
squares), counted from the stage shapes, whatever implements it. The
peaks, the sample's own operations and the bound are ``work``'s."""

from __future__ import annotations

from typing import Dict, Tuple

from . import work


def variance_work(D: int, H: int, W: int, C: int, dtype: str,
                  first: bool) -> Tuple[int, int]:
    """(bytes, operations) of one source view's variance step: the source
    features, the depth planes (float32) and the 3 x 4 matrix read once;
    the two (D, H, W, C) sums written once, and read once before unless
    this is the stage's first view, which writes them; SAMPLE_OPS and 9 a
    channel (the blend's 7, the square and the add) a sample."""
    e = work.DTYPE_BYTES[dtype]
    passes = 2 if first else 4
    nbytes = H * W * C * e + D * H * W * 4 + 48 + passes * D * H * W * C * e
    return nbytes, D * H * W * (work.SAMPLE_OPS + 9 * C)


def keyframe_bound_s(shapes: Dict[str, tuple], dtype: str,
                     source_views: int) -> float:
    """The least time of a keyframe's variance steps: at each stage the
    first source view writes the sums and each later one adds to them."""
    total = 0.0
    for shape in shapes.values():
        total += work.bound_s(*variance_work(*shape, dtype, True))
        total += (source_views - 1) * work.bound_s(
            *variance_work(*shape, dtype, False))
    return total
