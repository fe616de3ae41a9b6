"""Host ms a training step waits for its batch from the loader, median
over the window's steps."""

from benchmark.harness.readers import median


def read(trace):
    return median(trace.spans.get("loader_wait", []))
