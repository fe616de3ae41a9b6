"""Host ms of ``FullSystem._make_keyframe``, median over the window's
keyframes (the Timer's interval)."""

from benchmark.harness.readers import median


def read(trace):
    return median(trace.spans.get("make_keyframe", []))
