"""The reader of ``deconv_launches`` on a synthetic program log: the
decoder-step kernel's launches over the window's keyframes, and nothing
read from a program that keeps no log, records no such counter (a program
whose decoder runs through cuDNN) or fused no keyframe in the window."""

import importlib.util
from collections import deque
from pathlib import Path

import pytest

from benchmark.harness.tracing import Trace
from tandem_tpu_torch.utils import timer as tm

READER = Path(__file__).resolve().parents[1] / "metrics" / \
    "deconv_launches.py"
MS = 1_000_000


def read(trace):
    spec = importlib.util.spec_from_file_location("m_deconv_launches",
                                                  READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def trace(calls=4):
    """A window [10, 110] ms holding ``calls`` keyframes."""
    return Trace(window_s=0.1, kernels=[("k", 20 * MS, 2 * MS)], spans={},
                 counters={"backend_calls": calls},
                 facts={"t0_ns": 10 * MS, "t1_ns": 110 * MS})


def launched(*values, at=20):
    """One ``deconv.launches`` sample a call, 20 ms apart from ``at``, each
    beside the call's graph replay."""
    log = []
    for i, v in enumerate(values):
        log.append(tm.Sample("mvsnet_graph_replays", (at + 20 * i - 1) * MS,
                             1))
        log.append(tm.Sample("deconv.launches", (at + 20 * i) * MS, v))
    return log


@pytest.mark.parametrize("values,per_kf", [
    ((9, 9, 9, 9), 9.0),
    ((9, 9, 9), 6.75),
    ((3, 0, 9, 6), 4.5)])
def test_launches_a_keyframe(monkeypatch, values, per_kf):
    """The samples in the window over the window's keyframes; samples
    before and after the window left out."""
    log = ([tm.Sample("deconv.launches", 5 * MS, 9)] + launched(*values)
           + [tm.Sample("deconv.launches", 120 * MS, 9)])
    monkeypatch.setattr(tm, "LOG", deque(log, maxlen=tm.LOG_ENTRIES))
    assert read(trace()) == pytest.approx(per_kf)


@pytest.mark.parametrize("case", ["no log", "no counter", "no calls"])
def test_nothing_read_without_the_counter(monkeypatch, case):
    """A program without the log, one whose log holds the runner's other
    counters but no ``deconv.launches`` (the decoder through cuDNN), and a
    window with no keyframe give nothing."""
    if case == "no log":
        monkeypatch.delattr(tm, "LOG")
        assert read(trace()) is None
        return
    log = ([tm.Sample("mvsnet_graph_replays", 20 * MS, 1),
            tm.Sample("warp_variance.launches", 20 * MS, 12)]
           if case == "no counter" else launched(9))
    monkeypatch.setattr(tm, "LOG", deque(log, maxlen=tm.LOG_ENTRIES))
    assert read(trace(0 if case == "no calls" else 4)) is None
