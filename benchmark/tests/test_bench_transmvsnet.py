"""The cell ``mapping.transmvsnet_dtu_1152x864.kf_stream_seeded_arch`` on the
CPU at the fault tests' size, driven by its own driver
(``traffic/mapping_arch``: the program's factory, weights drawn from the
seed, TransMVSNet's reference): the sound run comes out correct, and runs
with the MVSNet's depth x 1.03 or with a cost that leaves out a source
view do not; and the readers of ``warp_correlation_roofline`` and
``fmt_ms`` on made-up traces."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import correlation, work
from benchmark.tests.drive import run_cell, scale_depth
from benchmark.traffic import mapping_arch

ROOT = Path(__file__).resolve().parents[2]
CELL = "mapping.transmvsnet_dtu_1152x864.kf_stream_seeded_arch"
W, H = 160, 128
SEED = 2 ** 31 + 77
# A short keyframe cycle (3 keyframes), so set-up fuses it quickly; a
# window of two calls or more on a loaded CPU, so that a sampled call has
# its render.
SMALL_STREAM = {"path": dict(json.loads(
    (ROOT / "benchmark" / "workloads" / "kf_stream_seeded_arch.json")
    .read_text())["path"], period=24), "sample_calls": 3}
SECONDS = 20.0


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _limits():
    return json.loads((ROOT / "benchmark" / "limits" / f"{CELL}.json")
                      .read_text())


def test_sound_run_is_correct():
    r = run_cell(CELL, "cpu", W, H, SECONDS, SEED, SMALL_STREAM)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(_limits())


def test_altered_depth_is_not_correct(monkeypatch):
    """The MVSNet's depth x 1.03 where the runner returns it
    (``mapping_arch`` builds its own map path, so the fault wraps its
    builder)."""
    build, fault = mapping_arch.build_map_path, scale_depth(1.03)

    def broken(*a, **k):
        runner, backend, scans = build(*a, **k)
        fault(runner, backend)
        return runner, backend, scans
    monkeypatch.setattr(mapping_arch, "build_map_path", broken)
    r = run_cell(CELL, "cpu", W, H, SECONDS, SEED, SMALL_STREAM)
    assert not r["correct"], r["checks"]
    assert r["checks"]["depth_rel_gap"] > 0.02
    assert r["checks"]["wta_flip_share"] > 0.5


def test_dropped_source_view_is_not_correct(monkeypatch):
    """The last source view of each stage left out of the cost (its
    similarity replaced by the first source view's): with BatchNorm at its
    initial statistics the plane probabilities are near uniform, and the
    winning plane follows the cost."""
    from tandem_tpu_torch.models import transmvsnet
    real, seen = transmvsnet.plane_sweep_correlation, []

    def dropping(*a, **k):
        sim = real(*a, **k)
        seen.append(sim)
        return seen[-4] if len(seen) % 4 == 0 else sim
    monkeypatch.setattr(transmvsnet, "plane_sweep_correlation", dropping)
    r = run_cell(CELL, "cpu", W, H, SECONDS, SEED, SMALL_STREAM)
    assert seen and not r["correct"], r["checks"]
    assert r["checks"]["wta_flip_share"] > 10 * _limits()["wta_flip_share"]


SHAPES = work.stage_shapes(json.loads(
    (ROOT / "benchmark" / "configs" / "transmvsnet_dtu_1152x864.json")
    .read_text())["model"], 864, 1152)


def _reader(name):
    """The metric's ``read``, loaded now (after ``_trace``'s patch)."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_"), ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _trace(calls, counts, times_ms, monkeypatch, counter):
    from benchmark.harness import program
    kernels = [("warp_correlation_kernel<float, 4>", 0, int(t * 1e6))
               for t in times_ms] + [("warp_sample_kernel", 0, 10 ** 6)]
    monkeypatch.setattr(program, "samples",
                        lambda trace, name: counts if name == counter
                        else None)
    return SimpleNamespace(
        kernels=kernels, counters={"backend_calls": calls},
        facts={"stage_shapes": SHAPES, "dtype": "float32"},
        kernel_ms=lambda match: [d / 1e6 for n, _, d in kernels
                                 if match(n)])


def test_roofline_reads_the_keyframes_bound(monkeypatch):
    """Two keyframes of 12 launches, each at twice its launch's mean bound,
    read 50%."""
    per_kf = correlation.keyframe_bound_s(SHAPES, "float32", 4)
    assert per_kf == pytest.approx(4 * sum(
        work.bound_s(*correlation.correlation_work(*s, "float32"))
        for s in SHAPES.values()))
    times = [2 * per_kf / 12 * 1e3] * 24
    trace = _trace(2, [12, 12], times, monkeypatch,
                   "warp_correlation.launches")
    # the kernels' nanoseconds are whole numbers
    assert _reader("warp_correlation_roofline")(trace) == pytest.approx(
        50.0, rel=1e-4)


@pytest.mark.parametrize("counts", [None, [], [12], [12, 11], [12, 12, 12],
                                    [13, 13]])
def test_roofline_needs_twelve_launches_a_keyframe(monkeypatch, counts):
    """No reading without the counter (the parent's program), with a
    keyframe of the window missing its sample, or with a count that is not
    the stages' source views."""
    trace = _trace(2, counts, [1.0] * 24, monkeypatch,
                   "warp_correlation.launches")
    assert _reader("warp_correlation_roofline")(trace) is None


@pytest.mark.parametrize("counts, want", [([3.0, 5.0, 4.0], 4.0),
                                          ([], None), (None, None)])
def test_fmt_ms_is_the_mean_sample(monkeypatch, counts, want):
    """The mean of the window's ``fmt.device_ms`` samples; None without
    the log or the counter (a program without an FMT, or the parent)."""
    trace = _trace(3, counts, [], monkeypatch, "fmt.device_ms")
    assert _reader("fmt_ms")(trace) == want
