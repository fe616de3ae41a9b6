"""The tracker LM kernel's share of its roofline: the least time of each
level call's work (its points, candidates and the evaluations it made),
summed, over the profiler's device time of the ``track_lm`` launches."""

from benchmark.harness import work


def read(trace):
    calls = trace.calls.get("track_lm", [])
    times = trace.kernel_ms(lambda n: "track_lm" in n)
    if not calls or len(times) != len(calls):
        return None
    bounds = [work.bound_s(b, ops) for b, ops in calls]
    return work.share_percent(bounds, [t / 1e3 for t in times])
