"""The keyframes' CVA-MVSNet forwards (their convolutions' operations,
counted from the unit's shapes) over the window, as a percent of the
card's dense peak in the model's dtype (989 TFLOP/s in bfloat16)."""

from benchmark.harness.readers import mvsnet_mfu


def read(trace):
    return mvsnet_mfu(trace)
