"""Synchronising CUDA calls a frame over the window (torch's sync debug
mode)."""


def read(trace):
    frames = trace.counters.get("frames", 0)
    return trace.counters["host_reads"] / frames if frames else None
