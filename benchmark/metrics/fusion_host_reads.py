"""The fusion's deliberate host reads a keyframe: the program's counter
``fusion_host_reads`` summed over the window, over the keyframes fused in
it."""

from benchmark.harness.program import samples, span_ms


def read(trace):
    reads = samples(trace, "fusion_host_reads")
    calls = trace.counters.get("backend_calls", 0)
    if reads is None or not calls or not span_ms(trace, "fusion"):
        return None
    return sum(reads) / calls
