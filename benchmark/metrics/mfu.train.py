"""The window's training steps (forward and backward: three times the
forward's convolution operations, counted from the shapes) over the
window, as a percent of the card's float32 peak outside the tensor cores
(67 TFLOP/s; TF32 is off)."""

from benchmark.harness import work


def read(trace):
    steps = trace.counters.get("steps", 0)
    if not steps or trace.window_s <= 0:
        return None
    return (100.0 * trace.facts["step_ops"] * steps / trace.window_s
            / work.PEAK_OPS_PER_S[trace.facts["dtype"]])
