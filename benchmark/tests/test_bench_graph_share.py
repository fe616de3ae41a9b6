"""The reader of ``mvsnet_graph_share`` on a synthetic program log: the
replayed calls among the window's keyframes, and nothing read from a
program that keeps no log or records no graph counter (a program before
the graphed runner)."""

import importlib.util
from collections import deque
from pathlib import Path

import pytest

from benchmark.harness.tracing import Trace
from tandem_tpu_torch.utils import timer as tm

READER = Path(__file__).resolve().parents[1] / "metrics" / \
    "mvsnet_graph_share.py"
MS = 1_000_000


def read(trace):
    spec = importlib.util.spec_from_file_location("m_mvsnet_graph_share",
                                                  READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def trace(calls=4):
    """A window [10, 110] ms holding ``calls`` keyframes."""
    return Trace(window_s=0.1, kernels=[("k", 20 * MS, 2 * MS)], spans={},
                 counters={"backend_calls": calls},
                 facts={"t0_ns": 10 * MS, "t1_ns": 110 * MS})


def replays(*values, at=20):
    """One ``mvsnet_graph_replays`` sample a call, 20 ms apart from ``at``;
    a capture's sample before the window."""
    return [tm.Sample("mvsnet_graph_captures", 5 * MS, 1)] + [
        tm.Sample("mvsnet_graph_replays", (at + 20 * i) * MS, v)
        for i, v in enumerate(values)]


@pytest.mark.parametrize("values,share", [
    ((1, 1, 1, 1), 100.0),
    ((0, 1, 1, 1), 75.0),
    ((0, 0, 0, 0), 0.0)])
def test_share_of_replayed_keyframes(monkeypatch, values, share):
    """Replayed calls over the window's keyframes, a sample outside the
    window left out."""
    log = replays(*values) + [tm.Sample("mvsnet_graph_replays", 120 * MS, 1)]
    monkeypatch.setattr(tm, "LOG", deque(log, maxlen=tm.LOG_ENTRIES))
    assert read(trace()) == pytest.approx(share)


@pytest.mark.parametrize("case", ["no log", "no graph counter", "no calls"])
def test_nothing_read_without_the_counter(monkeypatch, case):
    """A program without the log, one whose log holds no graph counter in
    the window (the runner before its graphs: spans only), and a window
    with no keyframe give nothing."""
    if case == "no log":
        monkeypatch.delattr(tm, "LOG")
        assert read(trace()) is None
        return
    log = ([tm.Span("mvsnet_dispatch", 20 * MS, 30 * MS)]
           if case == "no graph counter" else replays(1))
    monkeypatch.setattr(tm, "LOG", deque(log, maxlen=tm.LOG_ENTRIES))
    assert read(trace(0 if case == "no calls" else 4)) is None
