"""Percent of the traced window in which the card is idle and the host is
in no program span, or in a span's own time outside its child spans: the
idle the program cannot name yet."""

from benchmark.harness.program import idle_unnamed


def read(trace):
    return idle_unnamed(trace)
