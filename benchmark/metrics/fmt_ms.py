"""Device ms of a keyframe's Feature Matching Transformer: the program's
counter ``fmt.device_ms`` (a pair of CUDA events the model records around
its FMT, inside the runner's CUDA graph), mean over the window's samples.
None where the program keeps no log or records no such counter (a model
without an FMT, or a program before the counter)."""

from benchmark.harness.program import samples


def read(trace):
    ms = samples(trace, "fmt.device_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)
