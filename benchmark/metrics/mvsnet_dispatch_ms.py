"""Host ms of a keyframe's ``mvsnet_dispatch`` (the program's span around
the enqueue of the stage-3 forward and the edge filter), median over the
window's keyframes."""

from benchmark.harness.program import median_span_ms


def read(trace):
    return median_span_ms(trace, "mvsnet_dispatch")
