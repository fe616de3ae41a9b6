"""Each per-layer metric's reader on a recorded fake trace, the trace
arithmetic (busy union, idle gaps, device ops), and readers that find
nothing to read returning nothing."""

import importlib.util
from pathlib import Path

import pytest

from benchmark.harness import tracing, work
from benchmark.harness.tracing import Trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"
MS = 1_000_000
SHAPES = {"stage1": (48, 120, 160, 32), "stage2": (4, 240, 320, 16),
          "stage3": (4, 480, 640, 8)}


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def fake_trace():
    t0 = 10 * MS
    kernels = [("void track_lm_kernel<false>(Level)", t0 + 1 * MS, 2 * MS),
               ("void track_lm_kernel<false>(Level)", t0 + 2 * MS, 2 * MS),
               ("void warp_sample_kernel<bf16, 4>", t0 + 6 * MS, 1 * MS),
               ("void warp_sample_kernel<bf16, 4>", t0 + 6 * MS, 3 * MS),
               ("void warp_sample_kernel<bf16, 4>", t0 + 9 * MS, 2 * MS),
               ("void warp_sample_grad_kernel<float>", t0 + 12 * MS, MS)]
    return Trace(
        window_s=0.02, kernels=kernels,
        spans={"track_frame": [3.0, 1.0, 2.0], "make_keyframe": [100.0],
               "kf_ba": [40.0, 60.0], "mvsnet": [5.0, 7.0, 9.0],
               "fusion": [1.0, 2.0]},
        counters={"frames": 4, "host_reads": 10, "backend_calls": 2},
        calls={"track_lm": [(3.35e9, 0.0), (0.0, 67e9)],
               "warp_sample_grad": [(1.675e9, 0.0)]},
        facts={"t0_ns": t0, "t1_ns": t0 + 20 * MS, "dtype": "bfloat16",
               "mvsnet_ops": 989e9, "stage_shapes": SHAPES})


def test_busy_union_and_gaps():
    tr = fake_trace()
    t0, t1 = tr.facts["t0_ns"], tr.facts["t1_ns"]
    # [1, 4] + [6, 9] + [9, 11] + [12, 13] ms
    assert tracing.busy_ns(tr.kernels, t0, t1) == 9 * MS
    spans = [("frame", t0, t1), ("trace", t0 + 13 * MS, t0 + 20 * MS)]
    gaps = tracing.idle_gaps(tr.kernels, t0, t1, spans)
    assert gaps[0] == ["trace", 0.007]
    assert gaps[1] == ["frame", 0.002]
    assert sorted(g[1] for g in gaps) == [0.001, 0.001, 0.002, 0.007]
    ops = tracing.device_ops(tr.kernels)
    assert ops[0] == ["void warp_sample_kernel<bf16, 4>", 0.006]


def test_span_readers():
    tr = fake_trace()
    assert reader("track_ms")(tr) == 2.0
    assert reader("keyframe_ms")(tr) == 100.0
    assert reader("ba_ms")(tr) == 50.0
    assert reader("mvsnet_ms")(tr) == 7.0
    assert reader("fusion_ms")(tr) == 1.5
    assert reader("host_reads_per_frame")(tr) == 2.5


def test_device_readers():
    tr = fake_trace()
    for name in ("device_idle.slam", "device_idle.mapping"):
        assert reader(name)(tr) == pytest.approx(55.0)
    # 2 forwards of 989 GFLOP in 20 ms against 989 TFLOP/s
    for name in ("mfu.slam", "mfu.mapping"):
        assert reader(name)(tr) == pytest.approx(10.0)
    # two LM calls bound at 1 ms each, run in 4 ms
    assert reader("track_lm_roofline")(tr) == pytest.approx(50.0)
    per_stage = [work.bound_s(*work.sample_work(*s, "bfloat16"))
                 for s in SHAPES.values()]
    want = 100 * 3 * sum(per_stage) / 3 / 6e-3
    assert reader("warp_sample_roofline")(tr) == pytest.approx(want)
    # one backward call bound at 0.5 ms, its launch 1 ms
    assert reader("warp_sample_grad_roofline")(tr) == pytest.approx(50.0)


def test_backward_sample_count():
    """The backward's samples read and its work at a small shape, by hand:
    an identity projection lands every sample inside but those pushed out
    by the shift, and a plane behind the camera lands none."""
    import torch
    H, W = 3, 4
    mat = torch.tensor([[[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]]])
    depth = torch.ones((1, 2, H, W))
    assert int(work.grad_read_samples(mat, depth, H, W)) == 2 * H * W
    shifted = mat.clone()
    shifted[0, 0, 3] = 3.5           # px = x + 3.5: only x = 0 stays < W
    assert int(work.grad_read_samples(shifted, depth, H, W)) == 2 * H
    assert int(work.grad_read_samples(mat, -depth, H, W)) == 0
    nbytes, ops = work.sample_grad_work(1, 2, H, W, 8, 4, 2 * H)
    assert nbytes == 2 * H * 8 * 4 + 48 + 2 * H * W * 4 + H * W * 8 * 4
    assert ops == 2 * H * W * work.SAMPLE_OPS + 2 * H * 8 * 8


def test_readers_with_nothing_to_read_return_nothing():
    empty = Trace(window_s=1.0, kernels=[], spans={},
                  counters={"frames": 0, "host_reads": 0,
                            "backend_calls": 0},
                  facts={"t0_ns": 0, "t1_ns": MS, "dtype": "bfloat16",
                         "mvsnet_ops": 1.0})
    for path in sorted(METRICS.glob("*.py")):
        assert reader(path.stem)(empty) is None, path.stem


def test_track_lm_roofline_needs_one_record_a_launch():
    tr = fake_trace()
    tr.calls["track_lm"] = tr.calls["track_lm"][:1]
    assert reader("track_lm_roofline")(tr) is None
