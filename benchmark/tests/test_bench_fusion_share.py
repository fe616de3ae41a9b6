"""The reader of ``fusion_kernel_share`` on a synthetic program log: the
keyframes the fusion kernels fused among the window's keyframes, and
nothing read from a program that keeps no log, records no such counter (a
program before the fusion kernels) or fused no keyframe in the window."""

import importlib.util
from collections import deque
from pathlib import Path

import pytest

from benchmark.harness.tracing import Trace
from tandem_tpu_torch.utils import timer as tm

READER = Path(__file__).resolve().parents[1] / "metrics" / \
    "fusion_kernel_share.py"
MS = 1_000_000


def read(trace):
    spec = importlib.util.spec_from_file_location("m_fusion_kernel_share",
                                                  READER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def trace(calls=4):
    """A window [10, 110] ms holding ``calls`` keyframes."""
    return Trace(window_s=0.1, kernels=[("k", 20 * MS, 2 * MS)], spans={},
                 counters={"backend_calls": calls},
                 facts={"t0_ns": 10 * MS, "t1_ns": 110 * MS})


def fused(*values, at=20):
    """One ``fusion_kernels`` sample a call, 20 ms apart from ``at``, each
    beside the call's host read."""
    log = []
    for i, v in enumerate(values):
        log.append(tm.Sample("fusion_host_reads", (at + 20 * i - 5) * MS, 1))
        log.append(tm.Sample("fusion_kernels", (at + 20 * i) * MS, v))
    return log


@pytest.mark.parametrize("values,share", [
    ((1, 1, 1, 1), 100.0),
    ((0, 1, 0, 1), 50.0),
    ((0, 0, 0, 0), 0.0)])
def test_share_of_kernel_fused_keyframes(monkeypatch, values, share):
    """Kernel-fused keyframes over the window's keyframes; samples before
    and after the window left out."""
    log = ([tm.Sample("fusion_kernels", 5 * MS, 0)] + fused(*values)
           + [tm.Sample("fusion_kernels", 120 * MS, 0)])
    monkeypatch.setattr(tm, "LOG", deque(log, maxlen=tm.LOG_ENTRIES))
    assert read(trace()) == pytest.approx(share)


@pytest.mark.parametrize("case", ["no log", "no counter", "no calls"])
def test_nothing_read_without_the_counter(monkeypatch, case):
    """A program without the log, one whose log holds fusion spans and
    reads but no ``fusion_kernels`` (the torch-only fusion before the
    kernels), and a window with no keyframe give nothing."""
    if case == "no log":
        monkeypatch.delattr(tm, "LOG")
        assert read(trace()) is None
        return
    log = ([tm.Span("fusion", 20 * MS, 30 * MS),
            tm.Sample("fusion_host_reads", 25 * MS, 1)]
           if case == "no counter" else fused(1))
    monkeypatch.setattr(tm, "LOG", deque(log, maxlen=tm.LOG_ENTRIES))
    assert read(trace(0 if case == "no calls" else 4)) is None
