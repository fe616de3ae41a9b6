"""The plane-sweep sample's share of its roofline: the least time of the
samples the window's keyframes needed (one call a source view and stage,
counted from the stage shapes), over the profiler's device time of the
``warp_sample`` launches."""

from benchmark.harness import work


def read(trace):
    times = trace.kernel_ms(lambda n: "warp_sample" in n and "grad" not in n)
    shapes = trace.facts.get("stage_shapes")
    if not times or not shapes:
        return None
    per_stage = [work.bound_s(*work.sample_work(*s, trace.facts["dtype"]))
                 for s in shapes.values()]
    # a keyframe samples each stage once a source view, so the launches
    # split evenly over the stages
    bound = len(times) * sum(per_stage) / len(per_stage)
    return work.share_percent([bound], [sum(times) / 1e3])
