"""A bit-level fingerprint of a model's outputs."""

from __future__ import annotations

import hashlib


def digest(outputs) -> str:
    """sha256 of the bytes of ``outputs`` (a sequence of sequences of
    tensors, such as the stages of a CvaMVSNet forward), in the order
    given."""
    h = hashlib.sha256()
    for stage in outputs:
        for t in stage:
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()
