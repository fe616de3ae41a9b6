"""Hierarchical named-interval timer.

Parity target: tandem/src/util/Timer.h:21-60 — start/end named intervals,
per-key instance lists, and a dr_times.txt-style dump for comparability with
the reference's profiling output (enabled there by dr_timing=1).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List


class Timer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._open: Dict[int, tuple] = {}
        self._next_id = 0
        self.intervals: Dict[str, List[float]] = defaultdict(list)

    def start_timing(self, name: str) -> int:
        if not self.enabled:
            return -1
        tid = self._next_id
        self._next_id += 1
        self._open[tid] = (name, time.perf_counter())
        return tid

    def end_timing(self, name: str, tid: int, accumulate: bool = False):
        if not self.enabled or tid < 0:
            return
        key, t0 = self._open.pop(tid)
        assert key == name, f"Timer mismatch: {key} vs {name}"
        dt = (time.perf_counter() - t0) * 1e3  # ms
        if accumulate and self.intervals[name]:
            self.intervals[name][-1] += dt
        else:
            self.intervals[name].append(dt)

    def mean_ms(self, name: str) -> float:
        v = self.intervals.get(name, [])
        return sum(v) / len(v) if v else 0.0

    def write_to_file(self, path: str):
        """dr_times.txt-style dump: one line per key with all instances."""
        with open(path, "w") as f:
            for name in sorted(self.intervals):
                vals = self.intervals[name]
                mean = sum(vals) / len(vals)
                f.write(f"{name} n={len(vals)} mean_ms={mean:.3f} "
                        + " ".join(f"{v:.3f}" for v in vals) + "\n")
