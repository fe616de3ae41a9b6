"""The correlation cost volume's step's share of its roofline: the least time
of the window's ``warp_correlation`` launches (one a source view a stage;
bytes and operations from the stage shapes, ``harness/correlation.py``)
over the profiler's device time of those launches. None unless the
program's counter ``warp_correlation.launches`` holds one sample a keyframe
of the window, each 3 x the source views (12 at 5 views)."""

from benchmark.harness import correlation
from benchmark.harness.program import samples


def read(trace):
    times = trace.kernel_ms(lambda n: "warp_correlation" in n)
    shapes = trace.facts.get("stage_shapes")
    calls = trace.counters.get("backend_calls", 0)
    counts = samples(trace, "warp_correlation.launches")
    if not times or not shapes or not calls or not counts:
        return None
    per_call = counts[0]
    if (len(counts) != calls or any(c != per_call for c in counts)
            or per_call % len(shapes)):
        return None
    bound = correlation.keyframe_bound_s(shapes, trace.facts["dtype"],
                                         per_call // len(shapes))
    # the launches the profiler saw, at a keyframe's mean bound a launch
    return 100.0 * len(times) * bound / per_call / (sum(times) / 1e3)
