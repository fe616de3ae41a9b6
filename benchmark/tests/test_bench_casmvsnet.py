"""The cell ``mapping.casmvsnet_dtu_1152x864.kf_stream_seeded`` on the CPU at
the fault tests' size, driven by its own driver (``traffic/mapping_seeded``:
weights drawn from the seed, the variance reference): the sound run comes
out correct, and runs with the MVSNet's depth x 1.03 or with a cost volume
that leaves out a source view do not; and the reader of
``warp_variance_roofline`` on made-up traces."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import variance, work
from benchmark.tests.drive import run_cell, scale_depth

ROOT = Path(__file__).resolve().parents[2]
CELL = "mapping.casmvsnet_dtu_1152x864.kf_stream_seeded"
W, H = 160, 128
SEED = 2 ** 31 + 77
# A short keyframe cycle (3 keyframes), so set-up fuses it quickly; a
# window of two calls or more on a loaded CPU (a call of the 48/32/8
# cascade takes 3-10 s here), so that a sampled call has its render.
SMALL_STREAM = {"path": dict(json.loads(
    (ROOT / "benchmark" / "workloads" / "kf_stream_seeded.json").read_text()
)["path"], period=24), "sample_calls": 3}
SECONDS = 20.0


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def test_seeded_sound_run_is_correct():
    r = run_cell(CELL, "cpu", W, H, SECONDS, SEED, SMALL_STREAM)
    assert r["correct"], r["checks"]


def test_seeded_altered_depth_is_not_correct():
    r = run_cell(CELL, "cpu", W, H, SECONDS, SEED, SMALL_STREAM,
                 fault=scale_depth(1.03))
    assert not r["correct"], r["checks"]
    assert r["checks"]["depth_rel_gap"] > 0.02


def test_seeded_dropped_source_view_is_not_correct(monkeypatch):
    """The last source view of each stage never added to the variance's
    sums (the denominator still 5 views): with BatchNorm at its initial
    statistics the depth departs from the stage's middle plane by ~1e-5
    only, but that departure is the cost volume's, and the sampled calls'
    depth and confidence part from the reference's by more than ten times
    the cell's limits."""
    from tandem_tpu_torch.ops import warp
    real, calls = warp.warp_variance, [0]

    def dropping(img, mat, depth, sums=None, *a):
        calls[0] += 1
        if calls[0] % 4 == 0:
            return sums
        return real(img, mat, depth, sums, *a)
    monkeypatch.setattr(warp, "warp_variance", dropping)
    r = run_cell(CELL, "cpu", W, H, SECONDS, SEED, SMALL_STREAM)
    assert calls[0] and not r["correct"], r["checks"]
    assert r["checks"]["depth_rel_gap"] > 10 * _limits()["depth_rel_gap"]
    assert r["checks"]["conf_gap"] > 10 * _limits()["conf_gap"]


def _limits():
    return json.loads((ROOT / "benchmark" / "limits" / f"{CELL}.json")
                      .read_text())


SHAPES = work.stage_shapes(json.loads(
    (ROOT / "benchmark" / "configs" / "casmvsnet_dtu_1152x864.json")
    .read_text())["model"], 864, 1152)


def _trace(calls, counts, times_ms, monkeypatch):
    from benchmark.harness import program
    kernels = [("warp_variance_kernel<float, 4>", 0, int(t * 1e6))
               for t in times_ms] + [("warp_sample_kernel", 0, 10 ** 6)]
    monkeypatch.setattr(program, "samples",
                        lambda trace, name: counts if name ==
                        "warp_variance.launches" else None)
    return SimpleNamespace(
        kernels=kernels, counters={"backend_calls": calls},
        facts={"stage_shapes": SHAPES, "dtype": "float32"},
        kernel_ms=lambda match: [d / 1e6 for n, _, d in kernels
                                 if match(n)])


def _read(trace):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "warp_variance_roofline",
        ROOT / "benchmark" / "metrics" / "warp_variance_roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def test_roofline_reads_the_keyframes_bound(monkeypatch):
    """Two keyframes of 12 launches, each at twice its launch's mean bound,
    read 50%; the bound is the stage's first view writing the sums and
    three more adding to them."""
    per_kf = variance.keyframe_bound_s(SHAPES, "float32", 4)
    first = work.bound_s(*variance.variance_work(48, 216, 288, 32, "float32",
                                                 True))
    more = work.bound_s(*variance.variance_work(48, 216, 288, 32, "float32",
                                                False))
    assert more > 1.9 * first
    times = [2 * per_kf / 12 * 1e3] * 24
    got = _read(_trace(2, [12, 12], times, monkeypatch))
    assert got == pytest.approx(50.0)


@pytest.mark.parametrize("counts", [None, [], [12], [12, 11], [12, 12, 12],
                                    [13, 13]])
def test_roofline_needs_twelve_launches_a_keyframe(monkeypatch, counts):
    """No reading without the counter (the parent's program), with a
    keyframe of the window missing its sample, or with a count that is not
    the stages' source views."""
    assert _read(_trace(2, counts, [1.0] * 24, monkeypatch)) is None
