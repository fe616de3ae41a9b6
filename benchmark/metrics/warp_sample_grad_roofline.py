"""The plane sweep's backward kernel's share of its roofline: the least
time of each backward call's work (the incoming gradient of the samples
that land in the source image, read once; the depth planes and matrices;
the float32 sums written once; counted from each call's own matrices and
depths), summed, over the profiler's device time of the
``warp_sample_grad`` launches."""

from benchmark.harness import work


def read(trace):
    calls = trace.calls.get("warp_sample_grad", [])
    times = trace.kernel_ms(lambda n: "warp_sample_grad" in n)
    if not calls or not times:
        return None
    bounds = [work.bound_s(b, ops) for b, ops in calls]
    return work.share_percent(bounds, [t / 1e3 for t in times])
