"""Percent of the window's keyframes whose stage-3 forward and edge filter
the runner served by replaying a CUDA graph: the program's counter
``mvsnet_graph_replays`` (1 a replayed call, 0 a call of the graphed
forward that ran eagerly) summed over the window, over the keyframes fused
in it. None where the program keeps no log or records no such counter."""

from benchmark.harness.program import samples


def read(trace):
    replays = samples(trace, "mvsnet_graph_replays")
    calls = trace.counters.get("backend_calls", 0)
    if not replays or not calls:
        return None
    return 100.0 * sum(replays) / calls
