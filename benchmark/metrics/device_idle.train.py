"""Percent of the traced window in which no operation ran on the card."""

from benchmark.harness.readers import idle_percent


def read(trace):
    return idle_percent(trace)
