"""Host ms of a keyframe's windowed BA (the Timer's ``kf_ba``: the BA
iterations, the outlier removal and the read of the poses), median over
the window's keyframes."""

from benchmark.harness.readers import median


def read(trace):
    return median(trace.spans.get("kf_ba", []))
