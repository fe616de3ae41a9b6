"""The program's spans and counters where the work happens: the map path
(``MvsnetRunner`` + ``TandemBackend``), the loader (``make_batches``) and
the training step, recorded under a torch.profiler session as a traced
benchmark run records them; and, on the card, the map path's device spans
against the benchmark's own CUDA events over the same calls."""

import os
import time
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tandem_tpu_torch import config as pcfg
from tandem_tpu_torch.data.replica import MVSDataset, collate, make_batches
from tandem_tpu_torch.mapping.tsdf import TsdfConfig
from tandem_tpu_torch.models.convert import state_dict_to_flax
from tandem_tpu_torch.pipeline.backend import TandemBackend
from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
from tandem_tpu_torch.train import trainer as pt
from tandem_tpu_torch.utils import timer as tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "replica_traj")
V = 7
TSDF = dict(voxel_size=0.02, table_dim=64, pool_size=4096, truncation=0.08,
            max_depth=8.0)
# A 30 s traced window at up to 30 keyframes (or 10 steps) a second.
WINDOW_S, KF_PER_S, STEPS_PER_S = 30, 30, 10


@pytest.fixture
def log(monkeypatch):
    fresh = deque(maxlen=tm.LOG_ENTRIES)
    monkeypatch.setattr(tm, "LOG", fresh)
    return fresh


def _traced():
    """A profiler session, as a traced benchmark run opens over its
    window: the program's log records while it is on."""
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [
        ProfilerActivity.CPU]
    return profile(activities=acts)


def _map_path(device, height=128, width=160):
    config = pcfg.default()
    config.update({"MODEL.DEPTH_NUM": (8, 4, 4),
                   "MODEL.VIEW_AGGREGATION": True})
    model, _ = pt.create_train_state(config, torch.Generator().manual_seed(3),
                                     10)
    variables = state_dict_to_flax(model.state_dict(), view_aggregation=True)
    runner = MvsnetRunner(pt.model_from_config(config), variables, height,
                          width, view_num=V, device=device)
    K = np.array([[0.8 * width, 0, width / 2], [0, 0.8 * width, height / 2],
                  [0, 0, 1]], np.float32)
    return runner, TandemBackend(runner, TsdfConfig(**TSDF), K, height,
                                 width, mesh_extraction_freq=0)


def _windows(n_calls, height=128, width=160):
    rng = np.random.RandomState(0)
    tex = rng.randint(0, 256, (height, width + 8 * (n_calls + V), 3))
    frames = []
    for i in range(n_calls + V):
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 0.02 * i
        frames.append((tex[:, 8 * i:8 * i + width].astype(np.uint8), pose))
    return [([f[0] for f in frames[i:i + V]], [f[1] for f in frames[i:i + V]],
             frames[i + V - 1][1]) for i in range(n_calls)]


def _calls(backend, windows):
    for bgrs, poses, next_ref in windows:
        backend.call(bgrs, poses, 0.5, 4.0, next_ref)


def test_map_path_spans_per_call(log):
    """Each call records, in order: ``fusion`` (from the second call on),
    holding ``mvsnet_result`` and as many ``fusion_read``s as the counter
    ``fusion_host_reads`` adds, then ``mvsnet_pack``, ``mvsnet_upload`` and
    ``mvsnet_dispatch``; the Timer's ``backend_call`` holds them all.
    What a call writes fits the log's bound over a 30 s window."""
    runner, backend = _map_path("cpu")
    with _traced():
        _calls(backend, _windows(3))
    calls = [s for s in log if s.name == "backend_call"]
    assert len(calls) == 3
    for n, call in enumerate(calls):
        inside = sorted((e for e in log if e is not call
                         and call.start_ns <= e[1] <= call.end_ns
                         and (not isinstance(e, tm.Span)
                              or e.end_ns <= call.end_ns)),
                        key=lambda e: e[1])
        spans = [e for e in inside if isinstance(e, tm.Span)]
        top = [s for s in spans if not any(
            o is not s and o.start_ns <= s.start_ns and s.end_ns <= o.end_ns
            for o in spans)]
        want = ["mvsnet_pack", "mvsnet_upload", "mvsnet_dispatch"]
        assert [s.name for s in top] == (["fusion"] if n else []) + want
        if n == 0:
            continue
        fusion = top[0]
        held = [s for s in spans if s is not fusion
                and fusion.start_ns <= s.start_ns <= s.end_ns <= fusion.end_ns]
        names = [s.name for s in held]
        assert names[0] == "mvsnet_result"
        reads = [e for e in inside if isinstance(e, tm.Sample)]
        assert all(r.name == "fusion_host_reads" for r in reads)
        assert names.count("fusion_read") == sum(r.value for r in reads) >= 3
        assert set(names) == {"mvsnet_result", "fusion_upload", "fusion_read",
                              "fusion_cull", "fusion_integrate",
                              "fusion_render"}
        assert len(inside) * KF_PER_S * WINDOW_S < tm.LOG_ENTRIES


def test_dr_timing_lists_the_map_path_intervals(log):
    """Under ``dr_timing=1`` (an enabled Timer handed to the backend) the
    runner's and the fusion's spans are intervals of ``dr_times.txt``."""
    runner, _ = _map_path("cpu")
    timer = tm.Timer()
    backend = TandemBackend(runner, TsdfConfig(**TSDF), np.array(
        [[128, 0, 80], [0, 128, 64], [0, 0, 1]], np.float32), 128, 160,
        mesh_extraction_freq=0, timer=timer)
    _calls(backend, _windows(2))
    assert set(timer.intervals) == {
        "backend_call", "fusion", "fusion_read", "fusion_upload",
        "fusion_cull", "fusion_integrate", "fusion_render", "mvsnet_pack",
        "mvsnet_upload", "mvsnet_dispatch", "mvsnet_result"}
    assert len(timer.intervals["mvsnet_dispatch"]) == 2


class _Samples:
    """Dict samples, some slow to decode, so the lookahead is seen both
    ready and not."""

    def __len__(self):
        return 11

    def __getitem__(self, i):
        time.sleep(0.02 if i % 3 == 0 else 0.0)
        return {"image": np.full((2, 3), i, np.float32),
                "intrinsics": {"stage1": {"K": np.eye(3) * i}}}


def test_loader_spans_and_readiness(log):
    """``make_batches`` yields the same batches with its spans on; a
    request records one ``loader_blocked``, one ``loader_collate`` and one
    ``loader_ready`` sample in 0-3 (the taken batch and the lookahead of
    2)."""
    ds = _Samples()
    plain = list(make_batches(ds, 2, shuffle=True, seed=5, num_workers=3))
    with _traced():
        traced = list(make_batches(ds, 2, shuffle=True, seed=5,
                                   num_workers=3))
    assert len(traced) == len(plain) == 5
    for a, b in zip(plain, traced):
        assert np.array_equal(a["image"], b["image"])
        assert np.array_equal(a["intrinsics"]["stage1"]["K"],
                              b["intrinsics"]["stage1"]["K"])
    names = [e.name for e in log]
    assert names.count("loader_blocked") == names.count("loader_collate") \
        == names.count("loader_ready") == 5
    ready = [e.value for e in log if e.name == "loader_ready"]
    assert all(0 <= r <= 3 for r in ready)
    assert all(isinstance(e, tm.Span) for e in log
               if e.name != "loader_ready")


def test_train_step_records_its_five_spans(log):
    """A training step, as the CLI and the benchmark take it, records
    ``train_upload`` and then ``train_forward``, ``train_backward``,
    ``train_optimizer`` and ``train_metrics`` in order."""
    config = pcfg.default()
    config.update({"MODEL.DEPTH_NUM": (8, 8, 4), "TRAIN.BATCH_SIZE": 1,
                   "DATA.IMG_HEIGHT": 64, "DATA.IMG_WIDTH": 96})
    model, state = pt.create_train_state(
        config, torch.Generator().manual_seed(1), 50)
    step = pt.make_train_step(model, config)
    batch = collate([MVSDataset(FIXTURE, "val", height=64, width=96)[0]])
    with _traced():
        state, _ = step(state, pt.batch_to_device(batch, "cpu"))
    spans = sorted((e for e in log if isinstance(e, tm.Span)),
                   key=lambda s: s.start_ns)
    assert [s.name for s in spans] == [
        "train_upload", "train_forward", "train_backward", "train_optimizer",
        "train_metrics"]
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
    assert len(log) * STEPS_PER_S * WINDOW_S < tm.LOG_ENTRIES


@pytest.mark.cuda
def test_device_spans_agree_with_the_benchmarks_events():
    """On the card: the program's ``mvsnet`` and ``fusion`` device spans
    give the milliseconds of the benchmark's CUDA events
    (``benchmark/harness/tracing.EventSpans``, installed by the mapping
    driver) over the same calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events on the card)")
    from benchmark.harness.tracing import EventSpans, Spans
    from benchmark.traffic.common import Patches
    from benchmark.traffic.mapping import _instrument

    runner, backend = _map_path("cuda", 480, 640)
    windows = _windows(6, 480, 640)
    _calls(backend, windows[:2])                       # warm up
    runner.wait()
    spans, events, patches = Spans(), EventSpans(), Patches()
    _instrument(backend, runner, spans, events, patches)
    spans.on = True
    t0 = time.time_ns()
    with _traced():
        _calls(backend, windows[2:])
        runner.wait()
        torch.cuda.synchronize()
    patches.undo()
    mine = {name: [tm.device_ms(e) for e in tm.LOG
                   if isinstance(e, tm.DeviceSpan) and e.ns >= t0
                   and e.name == name] for name in ("mvsnet", "fusion")}
    for name, theirs in (("mvsnet", events.ms("mvsnet")),
                         ("fusion", events.ms("fusion"))):
        assert len(mine[name]) == len(theirs) == 4
        for a, b in zip(mine[name], theirs):
            assert abs(a - b) <= 0.05 + 0.01 * b, (name, a, b)
