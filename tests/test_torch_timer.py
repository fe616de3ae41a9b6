"""The port's Timer (``tandem_tpu_torch/utils/timer.py``): when it records
(built enabled, or under a torch.profiler session; nothing otherwise),
its clock (``time.time_ns``, the profiler's), nesting, the log's bound,
counters with their timestamps, and the ``dr_times.txt`` lines of the
reference's names."""

import time
from collections import deque
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tandem_tpu_torch.utils import timer as tm
from tandem_tpu_torch.utils.timer import Timer


@pytest.fixture
def log(monkeypatch):
    """A fresh log of the default bound, in place of the process's."""
    fresh = deque(maxlen=tm.LOG_ENTRIES)
    monkeypatch.setattr(tm, "LOG", fresh)
    return fresh


def _record(t: Timer):
    tid = t.start_timing("track_frame")
    t.end_timing("track_frame", tid)
    with t.span("mvsnet_dispatch"):
        pass
    t.count("fusion_host_reads")
    with t.device_span("mvsnet", None):
        pass


def test_records_nothing_when_off(log):
    t = Timer(enabled=False)
    assert not t.recording()
    _record(t)
    assert len(log) == 0 and not t.intervals
    assert t.span("x") is t.span("y")      # one shared do-nothing manager


def test_records_under_a_profiler_session(log):
    t = Timer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]):
        assert t.recording()
        _record(t)
    assert [type(e).__name__ for e in log] == ["Span", "Span", "Sample"]
    assert [e.name for e in log] == ["track_frame", "mvsnet_dispatch",
                                     "fusion_host_reads"]
    assert not t.intervals               # dr_times.txt is the enabled one's
    _record(t)                           # the session is over
    assert len(log) == 3


def test_records_when_enabled(log):
    t = Timer()
    _record(t)
    assert [e.name for e in log] == ["track_frame", "mvsnet_dispatch",
                                     "fusion_host_reads"]
    assert sorted(t.intervals) == ["mvsnet_dispatch", "track_frame"]


def test_every_instance_writes_the_one_log(log):
    a, b = Timer(), Timer(enabled=False)
    with profile(activities=[ProfilerActivity.CPU]):
        with a.span("outer"), b.span("inner"):
            pass
    assert [e.name for e in log] == ["inner", "outer"]


def test_spans_are_on_the_profilers_clock(log):
    t = Timer()
    before = time.time_ns()
    with t.span("a"):
        inside = time.time_ns()
    after = time.time_ns()
    tid = t.start_timing("b")
    t.end_timing("b", tid)
    end = time.time_ns()
    a, b = log
    assert before <= a.start_ns <= inside <= a.end_ns <= after
    assert after <= b.start_ns <= b.end_ns <= end
    assert t.intervals["a"][0] == pytest.approx(
        (a.end_ns - a.start_ns) / 1e6)


def test_spans_nest(log):
    t = Timer()
    with t.span("fusion"):
        with t.span("fusion_read"):
            pass
        with t.span("fusion_read"):
            pass
    r1, r2, outer = log
    assert outer.name == "fusion" and r1.name == r2.name == "fusion_read"
    assert outer.start_ns <= r1.start_ns <= r1.end_ns <= r2.start_ns
    assert r2.end_ns <= outer.end_ns


def test_the_log_is_bounded(monkeypatch):
    assert tm.LOG.maxlen == tm.LOG_ENTRIES == 65536
    small = deque(maxlen=4)
    monkeypatch.setattr(tm, "LOG", small)
    t = Timer()
    for i in range(6):
        with t.span(f"s{i}"):
            pass
    assert [e.name for e in small] == ["s2", "s3", "s4", "s5"]
    assert len(t.intervals) == 6          # the dump keeps every interval


def test_counters_carry_their_timestamps(log):
    t = Timer()
    before = time.time_ns()
    t.count("loader_ready", 2)
    mid = time.time_ns()
    t.count("loader_ready", 0)
    after = time.time_ns()
    (n1, ns1, v1), (n2, ns2, v2) = log
    assert n1 == n2 == "loader_ready" and (v1, v2) == (2, 0)
    assert before <= ns1 <= mid <= ns2 <= after


def test_device_span_needs_a_stream(log):
    t = Timer()
    with t.device_span("fusion", None):
        pass
    assert len(log) == 0


def test_dr_times_lines_unchanged(log, monkeypatch, tmp_path):
    """The reference's names give the lines they gave before the clock
    moved to time.time_ns: name, n, mean and every instance in ms."""
    clock = iter([0, 1_500_000, 2_000_000, 2_250_000, 3_000_000,
                  3_500_000, 4_000_000, 4_125_000])
    monkeypatch.setattr(tm, "time", SimpleNamespace(
        time_ns=lambda: next(clock)))
    t = Timer()
    for name in ("track_frame", "kf_ba"):
        tid = t.start_timing(name)
        t.end_timing(name, tid)
    tid = t.start_timing("track_frame")
    t.end_timing("track_frame", tid)
    tid = t.start_timing("track_frame")
    t.end_timing("track_frame", tid, accumulate=True)
    path = tmp_path / "dr_times.txt"
    t.write_to_file(str(path))
    assert path.read_text() == (
        "kf_ba n=1 mean_ms=0.250 0.250\n"
        "track_frame n=2 mean_ms=1.062 1.500 0.625\n")


def test_a_span_off_costs_little():
    """With recording off a span is one flag test and a shared manager:
    a fraction of a microsecond, held here to 10 us for a loaded host."""
    t = Timer(enabled=False)
    n = 20000
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with t.span("mvsnet_dispatch"):
            pass
    per = (time.perf_counter_ns() - t0) / n
    assert per < 10000, per
    assert not torch.autograd.profiler._is_profiler_enabled
