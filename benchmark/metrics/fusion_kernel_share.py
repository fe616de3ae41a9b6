"""Percent of the window's keyframes that the program fused with its
hand-written fusion kernels: the program's counter ``fusion_kernels`` (1 a
keyframe the card's kernels fused, 0 one the torch route fused) summed over
the window, over the keyframes fused in it. None where the program keeps no
log or records no such counter (a program before the fusion kernels)."""

from benchmark.harness.program import samples


def read(trace):
    fused = samples(trace, "fusion_kernels")
    calls = trace.counters.get("backend_calls", 0)
    if not fused or not calls:
        return None
    return 100.0 * sum(fused) / calls
