"""Device ms of a keyframe's CVA-MVSNet forward and edge filter (CUDA
events on the runner's stream), median over the window's keyframes."""

from benchmark.harness.readers import median


def read(trace):
    return median(trace.spans.get("mvsnet", []))
