"""Batches of the loader's lookahead with every sample decoded when a step
asks for one (the program's counter ``loader_ready``, the batch taken
included), mean over the window's requests."""

from benchmark.harness.program import samples


def read(trace):
    ready = samples(trace, "loader_ready")
    return sum(ready) / len(ready) if ready else None
