"""Arithmetic the per-layer metric readers share."""

from __future__ import annotations

import statistics

from . import work
from .tracing import busy_ns


def median(values):
    """The median of a non-empty list, else None (nothing to read)."""
    return statistics.median(values) if values else None


def idle_percent(trace):
    """100 x the share of the traced window in which no device operation
    ran."""
    t0, t1 = trace.facts["t0_ns"], trace.facts["t1_ns"]
    if t1 <= t0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - busy_ns(trace.kernels, t0, t1) / (t1 - t0))


def mvsnet_mfu(trace):
    """The MVSNet forwards' operations in the window over the window and
    the card's peak in the model's dtype, in percent."""
    calls = trace.counters.get("backend_calls", 0)
    if not calls or trace.window_s <= 0:
        return None
    peak = work.PEAK_OPS_PER_S[trace.facts["dtype"]]
    return 100.0 * trace.facts["mvsnet_ops"] * calls / trace.window_s / peak
