"""Percent of the traced window in which the card is idle while the host's
innermost program span is ``mvsnet_dispatch``."""

from benchmark.harness.program import idle_in


def read(trace):
    return idle_in(trace, ("mvsnet_dispatch",))
