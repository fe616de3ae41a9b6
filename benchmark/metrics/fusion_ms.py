"""Device ms of a keyframe's fusion (allocate, integrate, the culls and the
render for the tracker; CUDA events from the moment the stream holds the
MVSNet's answer), median over the window's keyframes."""

from benchmark.harness.readers import median


def read(trace):
    return median(trace.spans.get("fusion", []))
