"""The program's own spans and counters (``tandem_tpu_torch/utils/timer.py``:
one log per process, on the profiler's clock), read within the traced
window, and the card's idle time put down to the program's spans.

A traced run (``--trace 1``) opens a profiler session over its window, and
the program records its spans and counters while one is open. A program
that keeps no such log gives nothing here, and the readers then return
None.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple


def window_log(trace) -> Optional[tuple]:
    """The program's log within the window ``trace.facts`` t0_ns-t1_ns:
    (host spans that overlap it, clipped to it; counter samples inside it),
    or None where the program keeps no log or its log no longer holds the
    window's start."""
    try:
        from tandem_tpu_torch.utils import timer
    except ImportError:
        return None
    log = getattr(timer, "LOG", None)
    Span, Sample = getattr(timer, "Span", None), getattr(timer, "Sample", None)
    if log is None or Span is None or Sample is None:
        return None
    t0, t1 = trace.facts["t0_ns"], trace.facts["t1_ns"]
    entries = list(log)
    if entries and len(entries) == log.maxlen and entries[0][1] > t0:
        return None
    spans = [Span(e.name, max(e.start_ns, t0), min(e.end_ns, t1))
             for e in entries if isinstance(e, Span)
             and e.start_ns < t1 and e.end_ns > t0]
    samples = [e for e in entries
               if isinstance(e, Sample) and t0 <= e.ns <= t1]
    return spans, samples


def innermost(spans) -> Tuple[List[tuple], List[bool]]:
    """The innermost span over time: pieces (start, end, index into
    ``spans``) in order, and for each span whether it holds a child span.
    Spans nest (each recorded by a context manager on one thread); a span
    that outlasts the span it starts in is cut at that span's end."""
    order = sorted(range(len(spans)),
                   key=lambda i: (spans[i][1], -spans[i][2]))
    pieces, stack, parent = [], [], [False] * len(spans)

    def close_until(t):
        while stack and stack[-1][2] <= t:
            i, cursor, end = stack.pop()
            if end > cursor:
                pieces.append((cursor, end, i))
            if stack:
                stack[-1][1] = end

    for i in order:
        start, end = spans[i][1], spans[i][2]
        close_until(start)
        if stack:
            top = stack[-1]
            parent[top[0]] = True
            if start > top[1]:
                pieces.append((top[1], start, top[0]))
            end = min(end, top[2])
        stack.append([i, start, end])
    close_until(float("inf"))
    return pieces, parent


def idle_intervals(kernels, t0: int, t1: int) -> List[tuple]:
    """The intervals of [t0, t1] with no device operation (the complement
    of ``tracing.busy_ns``'s union)."""
    out, end = [], t0
    for _, s, d in kernels:
        if s > end:
            out.append((end, min(s, t1)))
        end = max(end, s + d)
        if end >= t1:
            break
    if end < t1:
        out.append((end, t1))
    return [(a, b) for a, b in out if b > a]


def idle_by_span(trace) -> Optional[dict]:
    """The window's idle card, in ns, by the innermost program span the
    host was in: {"leaf": {name: ns}, "own": {name: ns}, "outside": ns,
    "window": ns}. ``leaf`` holds spans with no child span, ``own`` the
    time of spans that hold children outside those children, ``outside``
    the idle in no program span. None without a log or a span in it."""
    got = window_log(trace)
    if got is None or not got[0]:
        return None
    spans = got[0]
    t0, t1 = trace.facts["t0_ns"], trace.facts["t1_ns"]
    pieces, parent = innermost(spans)
    leaf: Dict[str, int] = {}
    own: Dict[str, int] = {}
    outside, k = 0, 0
    for a, b in idle_intervals(trace.kernels, t0, t1):
        cursor = a
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            s, e, i = pieces[j]
            lo, hi = max(s, cursor), min(e, b)
            if hi > lo:
                outside += lo - cursor
                into = own if parent[i] else leaf
                into[spans[i][0]] = into.get(spans[i][0], 0) + hi - lo
                cursor = hi
            j += 1
        outside += b - cursor
    return {"leaf": leaf, "own": own, "outside": outside,
            "window": t1 - t0}


def idle_in(trace, names) -> Optional[float]:
    """100 x the share of the window in which the card is idle while the
    host's innermost span is one of ``names``."""
    idle = idle_by_span(trace)
    if idle is None:
        return None
    ns = sum(idle[part].get(n, 0) for part in ("leaf", "own")
             for n in names)
    return 100.0 * ns / idle["window"]


def idle_unnamed(trace) -> Optional[float]:
    """100 x the share of the window in which the card is idle and the host
    is in no program span, or in a span's own time outside its children."""
    idle = idle_by_span(trace)
    if idle is None:
        return None
    return (100.0 * (idle["outside"] + sum(idle["own"].values()))
            / idle["window"])


def span_ms(trace, name: str) -> List[float]:
    """Host ms of each ``name`` span that lies wholly inside the window."""
    got = window_log(trace)
    if got is None:
        return []
    t0, t1 = trace.facts["t0_ns"], trace.facts["t1_ns"]
    return [(s.end_ns - s.start_ns) / 1e6 for s in got[0]
            if s.name == name and t0 < s.start_ns and s.end_ns < t1]


def median_span_ms(trace, name: str) -> Optional[float]:
    ms = span_ms(trace, name)
    return statistics.median(ms) if ms else None


def samples(trace, name: str) -> Optional[List[float]]:
    """The values of the counter ``name`` sampled inside the window; None
    without a log."""
    got = window_log(trace)
    if got is None:
        return None
    return [s.value for s in got[1] if s.name == name]
