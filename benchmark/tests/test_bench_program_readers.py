"""The readers of the program's own spans and counters
(``harness/program.py`` and the nine metrics that use it) on a synthetic
program log and kernel list: each reader's number, the identity that the
idle under the leaf spans plus ``idle_unnamed.<cell>`` is the cell's
``device_idle.<cell>``, and nothing read from a program that keeps no log
or a log that lost the window's start."""

import importlib.util
from collections import deque
from pathlib import Path

import pytest

from benchmark.harness import program
from benchmark.harness.tracing import Trace
from tandem_tpu_torch.utils import timer as tm

METRICS = Path(__file__).resolve().parents[1] / "metrics"
MS = 1_000_000
S, C = tm.Span, tm.Sample


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ms(name, a, b):
    return S(name, a * MS, b * MS)


def mapping_log():
    """Two keyframe calls inside the window [10, 110] ms, a dispatch
    before it, and a call that runs past its end."""
    return [
        _ms("mvsnet_dispatch", 0, 8), C("fusion_host_reads", 5 * MS, 1),
        _ms("mvsnet_result", 11, 12), _ms("fusion_upload", 12, 15),
        C("fusion_host_reads", 16 * MS, 1), _ms("fusion_read", 16, 20),
        C("fusion_host_reads", 22 * MS, 1), _ms("fusion_read", 22, 24),
        _ms("fusion_integrate", 24, 30), _ms("fusion", 11, 30),
        _ms("mvsnet_pack", 31, 35),
        _ms("mvsnet_upload", 35, 38), _ms("mvsnet_dispatch", 38, 48),
        _ms("backend_call", 10, 50),
        _ms("mvsnet_result", 56, 57), C("fusion_host_reads", 60 * MS, 1),
        _ms("fusion_read", 60, 62), _ms("fusion", 56, 70),
        _ms("mvsnet_pack", 71, 73), _ms("mvsnet_upload", 73, 75),
        _ms("mvsnet_dispatch", 75, 95), _ms("backend_call", 55, 100),
        _ms("mvsnet_dispatch", 106, 115), _ms("backend_call", 105, 120)]


def mapping_trace():
    kernels = [("k", a * MS, (b - a) * MS)
               for a, b in ((20, 22), (40, 45), (60, 62), (80, 90))]
    return Trace(window_s=0.1, kernels=kernels, spans={},
                 counters={"backend_calls": 2},
                 facts={"t0_ns": 10 * MS, "t1_ns": 110 * MS})


def train_log():
    """Two batch requests and steps in the window [1000, 1100] ms."""
    out = []
    for t, ready, ends in (
            (1000, 1, (1011, 1013, 1015, 1030, 1050, 1052, 1055)),
            (1060, 3, (1062, 1065, 1066, 1080, 1095, 1096, 1098))):
        out.append(C("loader_ready", (t + 1) * MS, ready))
        start = t + 1
        for name, end in zip(("loader_blocked", "loader_collate",
                              "train_upload", "train_forward",
                              "train_backward", "train_optimizer",
                              "train_metrics"), ends):
            out.append(_ms(name, start, end))
            start = end
    return out


def train_trace():
    kernels = [("k", 1018 * MS, 40 * MS), ("k", 1068 * MS, 31 * MS)]
    return Trace(window_s=0.1, kernels=kernels, spans={},
                 counters={"steps": 2},
                 facts={"t0_ns": 1000 * MS, "t1_ns": 1100 * MS})


@pytest.fixture
def with_log(monkeypatch):
    def put(entries, maxlen=tm.LOG_ENTRIES):
        monkeypatch.setattr(tm, "LOG", deque(entries, maxlen=maxlen))
    return put


def test_mapping_readers(with_log):
    with_log(mapping_log())
    tr = mapping_trace()
    assert reader("mvsnet_dispatch_ms")(tr) == pytest.approx(15.0)
    assert reader("idle_in_dispatch.mapping")(tr) == pytest.approx(19.0)
    # fusion's own time 12, its reads 6 (the second call's read is busy),
    # its uploads 3, its integrate 6
    assert reader("idle_in_fusion.mapping")(tr) == pytest.approx(27.0)
    assert reader("fusion_host_reads")(tr) == pytest.approx(1.5)
    # backend_call's own time 12, fusion's 12, no span 10
    assert reader("idle_unnamed.mapping")(tr) == pytest.approx(34.0)
    assert reader("device_idle.mapping")(tr) == pytest.approx(81.0)


def test_train_readers(with_log):
    with_log(train_log())
    tr = train_trace()
    assert reader("loader_blocked_ms")(tr) == pytest.approx(5.5)
    assert reader("loader_ready_batches")(tr) == pytest.approx(2.0)
    assert reader("idle_in_step.train")(tr) == pytest.approx(8.0)
    assert reader("idle_unnamed.train")(tr) == pytest.approx(5.0)
    assert reader("device_idle.train")(tr) == pytest.approx(29.0)


@pytest.mark.parametrize("cell,log,trace", [
    ("mapping", mapping_log, mapping_trace),
    ("train", train_log, train_trace)])
def test_leaf_idle_and_unnamed_add_up_to_device_idle(with_log, cell, log,
                                                     trace):
    with_log(log())
    tr = trace()
    idle = program.idle_by_span(tr)
    leaves = 100.0 * sum(idle["leaf"].values()) / idle["window"]
    assert leaves + reader(f"idle_unnamed.{cell}")(tr) == pytest.approx(
        reader(f"device_idle.{cell}")(tr))
    want = ({"mvsnet_result": 2, "fusion_upload": 3, "fusion_read": 6,
             "fusion_integrate": 6, "mvsnet_pack": 6, "mvsnet_upload": 5,
             "mvsnet_dispatch": 19}
            if cell == "mapping" else
            {"loader_blocked": 11, "loader_collate": 5, "train_upload": 3,
             "train_forward": 5})
    assert idle["leaf"] == {k: v * MS for k, v in want.items()}


NINE = ("mvsnet_dispatch_ms", "idle_in_dispatch.mapping",
        "idle_in_fusion.mapping", "fusion_host_reads", "idle_unnamed.mapping",
        "loader_blocked_ms", "loader_ready_batches", "idle_in_step.train",
        "idle_unnamed.train")


@pytest.mark.parametrize("name", NINE)
def test_nothing_read_without_the_programs_log(monkeypatch, name):
    """A program before these spans (no ``LOG`` in its Timer module) gives
    nothing, and so does an empty log."""
    tr = mapping_trace() if "train" not in name and "loader" not in name \
        else train_trace()
    monkeypatch.delattr(tm, "LOG")
    assert reader(name)(tr) is None
    monkeypatch.setattr(tm, "LOG", deque(maxlen=8), raising=False)
    assert reader(name)(tr) is None


def test_nothing_read_from_a_log_that_lost_the_window(with_log):
    """A full log whose oldest entry is after the window's start no longer
    holds the whole window."""
    entries = mapping_log()[2:]
    with_log(entries, maxlen=len(entries))
    assert program.window_log(mapping_trace()) is None
    assert reader("idle_unnamed.mapping")(mapping_trace()) is None


def test_innermost_cuts_a_span_that_outlasts_its_parent():
    spans = [_ms("outer", 0, 10), _ms("inner", 2, 4), _ms("late", 6, 12)]
    pieces, parent = program.innermost(spans)
    assert [(a // MS, b // MS, spans[i].name) for a, b, i in pieces] == [
        (0, 2, "outer"), (2, 4, "inner"), (4, 6, "outer"), (6, 10, "late")]
    assert parent == [True, False, False]
