"""The work of the correlation cost volume's step (``warp_correlation``: one
source view's plane-sweep samples times the reference's features, averaged
over the channels), counted from the stage shapes, whatever implements it.
The peaks, the sample's own operations and the bound are ``work``'s."""

from __future__ import annotations

from typing import Dict, Tuple

from . import work


def correlation_work(D: int, H: int, W: int, C: int, dtype: str
                     ) -> Tuple[int, int]:
    """(bytes, operations) of one source view's correlation step: the
    source's and the reference's features, the depth planes (float32) and
    the 3 x 4 matrix read once, the float32 (D, H, W) similarity written
    once; SAMPLE_OPS and 9 a channel (the blend's 7, the product and the
    add) a sample, and its division by C."""
    e = work.DTYPE_BYTES[dtype]
    nbytes = 2 * H * W * C * e + D * H * W * 4 + 48 + D * H * W * 4
    return nbytes, D * H * W * (work.SAMPLE_OPS + 9 * C + 1)


def keyframe_bound_s(shapes: Dict[str, tuple], dtype: str,
                     source_views: int) -> float:
    """The least time of a keyframe's correlation steps: one a source view
    a stage."""
    return source_views * sum(
        work.bound_s(*correlation_work(*shape, dtype))
        for shape in shapes.values())
