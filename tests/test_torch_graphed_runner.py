"""The runner's graphed stage-3 forward (``GraphedStage3``) on the CPU: what
a CUDA graph is keyed on, the order of the eager warm-up, the capture and
the replays, the counters the runner records for them, the wrappers'
launch counts moved from a capture to its replays, and the copies in and
out of a graph's static tensors, with the graph itself stood in for. A
runner on the CPU keeps the eager forward. The card test
(``tests/test_torch_cuda.py``) holds the real graphs to the eager forward
bit for bit."""

import contextlib
from collections import deque

import numpy as np
import pytest
import torch

from tandem_tpu_torch.models.convert import state_dict_to_flax
from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet, Stage3Forward
from tandem_tpu_torch.ops.bilinear_sample import warp_sample
from tandem_tpu_torch.ops.deconv3d import deconv_bn_relu_add
from tandem_tpu_torch.ops.edge_kth import edge_filter
from tandem_tpu_torch.pipeline import mvsnet_runner as mr
from tandem_tpu_torch.utils import timer as tm

H, W, V = 64, 96, 4


@pytest.fixture
def log(monkeypatch):
    fresh = deque(maxlen=tm.LOG_ENTRIES)
    monkeypatch.setattr(tm, "LOG", fresh)
    return fresh


def _inputs(discard=10.0, height=H, dtype=torch.float32, seed=0,
            depth_range=(0.5, 6.0)):
    """The seven device tensors of a stage-3 call and its percentage."""
    g = torch.Generator().manual_seed(seed)
    K = torch.tensor([[[60.0, 0, 47.5], [0, 60.0, 31.5], [0, 0, 1]]])
    c2w = torch.eye(4).repeat(1, V, 1, 1)
    c2w[0, :, 0, 3] = 0.05 * torch.arange(V)
    tensors = (torch.rand(1, V, 3, height, W, generator=g).to(dtype),
               K * 0.25, K * 0.5, K, c2w, torch.full((1,), depth_range[0]),
               torch.full((1,), depth_range[1]))
    return tensors, torch.full((1,), discard)


def test_cpu_runner_keeps_the_eager_forward(log):
    """A runner on the CPU serves ``Stage3Forward`` itself and records no
    graph counter, while its spans are recorded."""
    torch.manual_seed(0)
    model = CvaMVSNet(depth_num=(8, 4, 4), view_aggregation=True)
    variables = state_dict_to_flax(model.state_dict(), view_aggregation=True)
    runner = mr.MvsnetRunner(CvaMVSNet(depth_num=(8, 4, 4),
                                       view_aggregation=True),
                             variables, H, W, view_num=V, device="cpu")
    assert type(runner._forward) is Stage3Forward
    runner.timer = tm.Timer()
    rng = np.random.RandomState(1)
    K = np.array([[60.0, 0, 47.5], [0, 60.0, 31.5], [0, 0, 1]], np.float32)
    poses = [np.eye(4, dtype=np.float32) for _ in range(V)]
    for dmax in (5.0, 6.0):
        runner.call_async([rng.randint(0, 256, (H, W, 3), np.uint8)
                           for _ in range(V)], poses, K, 0.5, dmax)
        out = runner.get_result()
        assert out["depth"].shape == (H, W)
    assert not [e for e in log if e.name.startswith("mvsnet_graph")]
    assert [e.name for e in log].count("mvsnet_dispatch") == 2


@pytest.mark.parametrize("change,same", [
    ("nothing", True),
    ("a copy of every tensor", True),
    ("the image's height", False),
    ("the image's dtype", False),
    ("the depth range", True),
    ("the discard percentage", False)])
def test_graph_key_separates_shapes_dtypes_and_discard_values(change, same):
    """Two calls share a graph exactly when their tensors' shapes and
    dtypes and the percentage's host value agree; the tensors' values (the
    image's, the depth range's) and storage do not matter."""
    tensors, pct = _inputs()
    other = {"nothing": lambda: (tensors, pct),
             "a copy of every tensor": lambda: _inputs(seed=1),
             "the image's height": lambda: _inputs(height=H + 32),
             "the image's dtype": lambda: _inputs(dtype=torch.bfloat16),
             "the depth range": lambda: _inputs(depth_range=(0.4, 5.0)),
             "the discard percentage": lambda: _inputs(discard=20.0)}[
        change]()
    with torch.no_grad():
        a, b = mr.graph_key(tensors, pct), mr.graph_key(*other)
    assert a is not None and b is not None
    assert (a == b) is same


def test_graph_key_none_for_a_percentage_off_the_cpu():
    """A percentage held off the CPU gives no key: on the card reading it
    would wait (the meta device stands in)."""
    tensors, pct = _inputs()
    assert mr.graph_key(tensors, pct.to("meta")) is None


class _FakeCapture:
    """Stands in for ``_CapturedForward``: records its captures and its
    replays."""
    made = []

    def __init__(self, forward, tensors, discard_percentage):
        self.pct = float(discard_percentage[0])
        self.replays = 0
        _FakeCapture.made.append(self)

    def __call__(self, tensors):
        self.replays += 1
        return ("replay", self.pct, self.replays)


def _graphed(monkeypatch):
    """A ``GraphedStage3`` over a stand-in forward and stand-in captures,
    and the list of the percentages the forward ran eagerly."""
    _FakeCapture.made = []
    monkeypatch.setattr(mr, "_CapturedForward", _FakeCapture)
    eager = []

    def forward(*inputs):
        pct = inputs[-1]
        eager.append("meta" if pct.is_meta else float(pct[0]))
        return ("eager",)

    return mr.GraphedStage3(forward), eager


def test_graphed_forward_warms_up_captures_then_replays(monkeypatch):
    """A key's first call runs eagerly, its second captures and replays,
    later ones replay; a new percentage starts over with a graph of its
    own; a call with no key runs eagerly. ``served`` names each."""
    graphed, eager = _graphed(monkeypatch)
    t10, p10 = _inputs(10.0)
    t20, p20 = _inputs(20.0)
    got, served = [], []
    for t, p in [(t10, p10)] * 3 + [(t20, p20)] * 2 + [
            (t10, p10.to("meta")), (t10, p10)]:
        got.append(graphed(*t, p))
        served.append(graphed.served)
    assert got == [("eager",), ("replay", 10.0, 1), ("replay", 10.0, 2),
                   ("eager",), ("replay", 20.0, 1), ("eager",),
                   ("replay", 10.0, 3)]
    assert served == ["eager", "capture", "replay", "eager", "capture",
                      "eager", "replay"]
    assert eager == [10.0, 20.0, "meta"]
    assert [c.pct for c in _FakeCapture.made] == [10.0, 20.0]


def test_runner_counts_graph_captures_and_replays(monkeypatch, log):
    """The runner records, through its current timer, 1 under
    ``mvsnet_graph_captures`` a capture and under ``mvsnet_graph_replays``
    1 a call a graph served and 0 an eager one; a forward put in place of
    the graphed one (the benchmark's control) records neither."""
    graphed, _ = _graphed(monkeypatch)
    runner = object.__new__(mr.MvsnetRunner)
    runner._forward = graphed
    runner.timer = tm.Timer()
    calls = [(*t, p) for t, p in [_inputs(10.0)] * 3 + [_inputs(20.0)] * 2]
    feed = iter(calls)
    runner._device_inputs = lambda *_: next(feed)
    for _ in calls:
        mr.MvsnetRunner._run(runner, None, None, None, 0.5, 6.0, None)
    runner._forward = lambda *inputs: ("control",)
    runner._device_inputs = lambda *_: calls[0]
    assert mr.MvsnetRunner._run(runner, None, None, None, 0.5, 6.0,
                                None) == ("control",)
    samples = [(e.name, e.value) for e in log if isinstance(e, tm.Sample)]
    assert samples.count(("mvsnet_graph_captures", 1)) == 2
    assert [v for n, v in samples if n == "mvsnet_graph_replays"] == [
        0, 1, 1, 0, 1]
    assert [e.name for e in log].count("mvsnet_dispatch") == 6


def test_captured_forward_counts_launches_at_each_replay(monkeypatch):
    """The wrappers' counts that a capture moves (it records kernels and
    launches none) are taken back after it and added at each replay, so
    they count the launches that ran."""
    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, **kw: contextlib.nullcontext())
    monkeypatch.setattr(warp_sample, "launches", 100)
    monkeypatch.setattr(edge_filter, "launches", 200)
    monkeypatch.setattr(edge_filter, "calls", 50)

    def forward(image, *rest):
        warp_sample.launches += 9
        edge_filter.launches += 4
        edge_filter.calls += 1
        return (image.sum(1),)

    def counts():
        return warp_sample.launches, edge_filter.launches, edge_filter.calls

    tensors, pct = _inputs()
    captured = mr._CapturedForward(forward, tensors, pct)
    assert counts() == (100, 200, 50)
    captured(tensors)
    captured(tensors)
    assert counts() == (118, 208, 52)


def test_decoder_step_launches_counted_at_each_replay_and_recorded(
        monkeypatch, log):
    """The decoder-step kernel's launches (9 a forward: 3 stages x 3
    steps) are taken back after a capture and added at each replay, and
    the runner records each call's launches under ``deconv.launches``: 9
    for the eager call, the capture and the replay alike."""
    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, **kw: contextlib.nullcontext())
    monkeypatch.setattr(deconv_bn_relu_add, "launches", 100)

    def forward(image, *rest):
        deconv_bn_relu_add.launches += 9
        return (image.sum(1),)

    tensors, pct = _inputs()
    runner = object.__new__(mr.MvsnetRunner)
    runner._forward = mr.GraphedStage3(forward)
    runner.timer = tm.Timer()
    runner._device_inputs = lambda *_: (*tensors, pct)
    for _ in range(3):
        mr.MvsnetRunner._run(runner, None, None, None, 0.5, 6.0, None)
    assert deconv_bn_relu_add.launches == 127
    assert [e.value for e in log if isinstance(e, tm.Sample)
            and e.name == "deconv.launches"] == [9, 9, 9]


class _RunForward:
    """Stands in for a CUDA graph: a replay runs the forward on the static
    inputs and writes the static outputs in place, as a graph does."""

    def __init__(self, forward, inputs, outputs):
        self.forward, self.inputs, self.outputs = forward, inputs, outputs

    def replay(self):
        for static, y in zip(self.outputs, self.forward(*self.inputs)):
            static.copy_(y)


def test_captured_forward_copies_in_and_out():
    """Each call copies its inputs into the static ones and hands out
    copies of the static outputs: a later call leaves earlier outputs as
    they were, and none shares storage with the graph's."""
    def forward(image, *rest):
        return image.sum(1) * rest[-1], image.amax(1)

    tensors, pct = _inputs()
    captured = object.__new__(mr._CapturedForward)
    captured.inputs = tuple(torch.empty_like(x) for x in tensors)
    captured.outputs = tuple(torch.empty_like(y) for y in forward(*tensors))
    captured.graph = _RunForward(forward, captured.inputs, captured.outputs)
    captured.launches = [0, 0, 0]
    first = captured(tensors)
    kept = [y.clone() for y in first]
    later, _ = _inputs(seed=2)
    second = captured(later)
    for got, want in zip(first, kept):
        assert torch.equal(got, want)
    for got, want in zip(second, forward(*later)):
        assert torch.equal(got, want)
    for y in first + second:
        assert all(y.untyped_storage().data_ptr()
                   != s.untyped_storage().data_ptr()
                   for s in captured.outputs)
    assert torch.equal(captured.inputs[0], later[0])
