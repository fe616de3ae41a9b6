"""What a traced run (``--trace 1``) records, and the trace it hands to the
per-layer metric readers.

- Host spans: the benchmark wraps calls into the program's layers
  (``Spans.wrapped``) and records each call's wall-clock interval
  (``time.time_ns``, the clock of the profiler's timestamps).
- Device events: one ``torch.profiler`` session over the window, CUDA
  activity only (kernels, copies and sets), read from the profiler's raw
  events.
- Host reads: the synchronising CUDA calls, counted by torch's sync debug
  mode (a copy of ``chip_smoke.py``'s counter) in a phase of their own,
  since its warnings slow the host.
- CUDA-event spans on a chosen stream (``EventSpans``), read once the
  window has closed.

Nothing here runs in an untraced run: the drivers wrap and record only
when ``--trace 1``.
"""

from __future__ import annotations

import functools
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List

import torch


class Spans:
    """Host intervals of wrapped calls: (name, start ns, end ns)."""

    def __init__(self):
        self.items: List[tuple] = []
        self.on = False

    def wrapped(self, fn, name: str):
        """``fn`` with a span recorded around each call while recording
        is on."""
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.time_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                self.items.append((name, t0, time.time_ns()))
        return wrapper


class EventSpans:
    """CUDA-event pairs recorded on the current stream at the start and
    end of a region; device ms each, read after the window."""

    def __init__(self):
        self.pairs: Dict[str, List[list]] = {}

    def start(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs.setdefault(name, []).append([ev, None])

    def end(self, name: str):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs[name][-1][1] = ev

    def ms(self, name: str) -> List[float]:
        return [a.elapsed_time(b) for a, b in self.pairs.get(name, [])
                if b is not None]


@dataclass
class Trace:
    """What the per-layer readers see."""
    window_s: float
    kernels: List[tuple]                 # (name, start ns, duration ns)
    spans: Dict[str, List[float]]        # host or device ms, by name
    counters: Dict[str, float]
    calls: Dict[str, list] = field(default_factory=dict)
    facts: Dict[str, object] = field(default_factory=dict)

    def kernel_ms(self, match: Callable[[str], bool]) -> List[float]:
        return [d / 1e6 for n, _, d in self.kernels if match(n)]


class DeviceTrace:
    """One profiler session over the traced window (CUDA activity)."""

    def __init__(self):
        self.prof = None
        self.t0_ns = self.t1_ns = 0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1_ns = time.time_ns()
        torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        return False

    def kernels(self) -> List[tuple]:
        """Device operations inside the window: (name, start ns, ns)."""
        out = []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            out.append((ev.name(), ev.start_ns(), ev.duration_ns()))
        out.sort(key=lambda e: e[1])
        return out


class SyncCounter:
    """The synchronising CUDA calls made inside it, by torch's sync debug
    mode."""

    def __init__(self):
        self.count = 0
        self._warn = self._seen = None

    def __enter__(self):
        self._warn = warnings.catch_warnings(record=True)
        self._seen = self._warn.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)
        self.count = sum("synchroniz" in str(w.message) for w in self._seen)
        self._warn.__exit__(*exc)
        return False


def busy_ns(kernels: List[tuple], t0: int, t1: int) -> int:
    """Length of the union of the device intervals (sorted by start),
    clipped to [t0, t1]."""
    total, end = 0, t0
    for _, s, d in kernels:
        a, b = max(s, t0, end), min(s + d, t1)
        if b > a:
            total += b - a
            end = b
    return total


def idle_gaps(kernels: List[tuple], t0: int, t1: int, spans: List[tuple],
              top: int = 10) -> List[list]:
    """The longest intervals of [t0, t1] with no device operation, each
    named by the innermost host span that covers its middle (the host's
    work while the device waited)."""
    gaps, end = [], t0
    for _, s, d in kernels:
        if s > end:
            gaps.append((end, min(s, t1)))
        end = max(end, s + d)
    if end < t1:
        gaps.append((end, t1))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        mid = (a + b) // 2
        inner = [s for s in spans if s[1] <= mid <= s[2]]
        name = max(inner, key=lambda s: s[1])[0] if inner else "harness"
        out.append([name, (b - a) / 1e9])
    return out


def device_ops(kernels: List[tuple], top: int = 10) -> List[list]:
    """Device time by operation name, the largest first (seconds)."""
    acc: Dict[str, int] = {}
    for n, _, d in kernels:
        acc[n] = acc.get(n, 0) + d
    return [[n, t / 1e9] for n, t in
            sorted(acc.items(), key=lambda kv: -kv[1])[:top]]


def short_name(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit]


def make_breakdown(kernels, t0: int, t1: int, spans) -> dict:
    return {"device_ops": [[short_name(n), s] for n, s in
                           device_ops(kernels)],
            "idle_gaps": idle_gaps(kernels, t0, t1, spans)}
