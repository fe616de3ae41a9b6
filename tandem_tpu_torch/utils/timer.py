"""Named intervals, and the process's one log of spans and counters.

Parity target: tandem/src/util/Timer.h:21-60 — start/end named intervals,
per-key instance lists, and a dr_times.txt-style dump for comparability with
the reference's profiling output (enabled there by dr_timing=1).

Every span of the process, whichever ``Timer`` records it, also lands in
one bounded log, ``LOG``, on ``time.time_ns`` (the clock of the profiler's
timestamps), so a reader can take a window of it by time:

- ``Span(name, start_ns, end_ns)``: a host interval (``start_timing`` /
  ``end_timing`` or ``span``);
- ``Sample(name, ns, value)``: a counter's sample (``count``);
- ``DeviceSpan(name, ns, start, end)``: a pair of CUDA events recorded on
  a stream around a block (``device_span``), ``ns`` the host time of the
  first; ``device_ms`` resolves it once read.

A Timer records while it was built enabled (``dr_timing=1``) or while a
``torch.profiler`` session is active in the process; otherwise a span costs
one flag test and records nothing. Only an enabled Timer keeps
``intervals``, the lists ``dr_times.txt`` is written from. The log holds
``LOG_ENTRIES`` entries and then drops its oldest.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict, deque
from typing import Any, Dict, List, NamedTuple

import torch

# ``_is_profiler_enabled``: a torch.profiler session is on in the process
_profiler = torch.autograd.profiler

# A traced 30 s window of the mapping cell writes ~14 entries a keyframe at
# ~16 keyframes a second (~6,800); the training cell ~8 a step at ~1 step a
# second.
LOG_ENTRIES = 1 << 16


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


class Sample(NamedTuple):
    name: str
    ns: int
    value: float


class DeviceSpan(NamedTuple):
    name: str
    ns: int
    start: Any          # torch.cuda.Event
    end: Any


LOG: deque = deque(maxlen=LOG_ENTRIES)
_OFF = contextlib.nullcontext()


def device_ms(entry: DeviceSpan) -> float:
    """A device span's milliseconds on its stream (waits for its end)."""
    entry.end.synchronize()
    return entry.start.elapsed_time(entry.end)


class Timer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._open: Dict[int, tuple] = {}
        self._next_id = 0
        self.intervals: Dict[str, List[float]] = defaultdict(list)

    def recording(self) -> bool:
        return self.enabled or _profiler._is_profiler_enabled

    def start_timing(self, name: str) -> int:
        if not (self.enabled or _profiler._is_profiler_enabled):
            return -1
        tid = self._next_id
        self._next_id += 1
        self._open[tid] = (name, time.time_ns())
        return tid

    def end_timing(self, name: str, tid: int, accumulate: bool = False):
        if tid < 0:
            return
        key, t0 = self._open.pop(tid)
        assert key == name, f"Timer mismatch: {key} vs {name}"
        self._close(name, t0, time.time_ns(), accumulate)

    def _close(self, name: str, t0: int, t1: int, accumulate: bool = False):
        LOG.append(Span(name, t0, t1))
        if not self.enabled:
            return
        dt = (t1 - t0) / 1e6  # ms
        if accumulate and self.intervals[name]:
            self.intervals[name][-1] += dt
        else:
            self.intervals[name].append(dt)

    def span(self, name: str):
        """A context manager: the block's host interval under ``name``."""
        if not (self.enabled or _profiler._is_profiler_enabled):
            return _OFF
        return _HostSpan(self, name)

    def count(self, name: str, value: float = 1):
        """A timestamped sample of the counter ``name``."""
        if self.enabled or _profiler._is_profiler_enabled:
            LOG.append(Sample(name, time.time_ns(), value))

    def device_span(self, name: str, stream):
        """A context manager: CUDA events recorded on ``stream`` before and
        after the block; nothing without a stream (the CPU)."""
        if stream is None or not (self.enabled
                                  or _profiler._is_profiler_enabled):
            return _OFF
        return _DeviceSpan(name, stream)

    def write_to_file(self, path: str):
        """dr_times.txt-style dump: one line per key with all instances."""
        with open(path, "w") as f:
            for name in sorted(self.intervals):
                vals = self.intervals[name]
                mean = sum(vals) / len(vals)
                f.write(f"{name} n={len(vals)} mean_ms={mean:.3f} "
                        + " ".join(f"{v:.3f}" for v in vals) + "\n")


class _HostSpan:
    __slots__ = ("timer", "name", "t0")

    def __init__(self, timer: Timer, name: str):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.t0 = time.time_ns()

    def __exit__(self, *exc):
        self.timer._close(self.name, self.t0, time.time_ns())
        return False


class _DeviceSpan:
    __slots__ = ("name", "stream", "ns", "start")

    def __init__(self, name: str, stream):
        self.name, self.stream = name, stream

    def __enter__(self):
        self.ns = time.time_ns()
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record(self.stream)

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record(self.stream)
        LOG.append(DeviceSpan(self.name, self.ns, self.start, end))
        return False
