"""Launches of the cost regulariser's decoder-step kernel a keyframe: the
program's counter ``deconv.launches`` (the kernel's launches in a runner
call, 9 a keyframe: 3 stages x 3 decoder steps) summed over the window,
over the keyframes fused in it. None where the program keeps no log or
records no such counter (a program that runs the decoder through
cuDNN)."""

from benchmark.harness.program import samples


def read(trace):
    launches = samples(trace, "deconv.launches")
    calls = trace.counters.get("backend_calls", 0)
    if not launches or not calls:
        return None
    return sum(launches) / calls
