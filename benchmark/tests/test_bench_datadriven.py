"""A cell and a per-layer metric are added by adding files and manifest
entries alone: a copy of the benchmark gains a dummy traffic driver, a
traffic file, limits and a metric reader, and ``run.py`` (unchanged) runs
the new cell, traced and untraced, with the card's calls stubbed."""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]

DRIVER = '''
import time
from benchmark.harness.tracing import Trace


def run(ctx):
    t0 = time.time_ns()
    done = ctx.traffic["items"]
    kernels = [("k_a", t0 + 100, 400), ("k_b", t0 + 300, 400)]
    out = {"attempted": done, "failed": 0,
           "e2e": {"items_per_s": done / ctx.seconds,
                   "setup_s": time.time() - ctx.t_start},
           "window_s": ctx.seconds, "host_spans": [("step", t0, t0 + 2000)],
           "trace": Trace(window_s=ctx.seconds, kernels=kernels, spans={},
                          counters={"items": done},
                          facts={"t0_ns": t0, "t1_ns": t0 + 2000})}
    out["release"] = lambda: None
    out["check"] = lambda: [("gap", ctx.traffic["gap"], ctx.limits["gap"])]
    return out
'''

READER = '''
def read(trace):
    return trace.counters["items"] * 2.0
'''


@pytest.fixture()
def tree(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    (b / "traffic" / "dummy.py").write_text(DRIVER)
    (b / "workloads" / "dummy_mix.json").write_text(json.dumps(
        {"driver": "dummy", "items": 12, "gap": 0.5}))
    (b / "limits" / "dummy.cell.json").write_text(json.dumps({"gap": 1.0}))
    (b / "metrics" / "items_twice.py").write_text(READER)
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": "dummy.cell", "config":
                                  manifest["configs"][0]["name"],
                                  "traffic": "dummy_mix", "chips": 1,
                                  "why": "a test cell"})
    manifest["end_to_end"].append({"name": "items_per_s", "unit": "1/s",
                                   "better": "higher", "bound": 0.05,
                                   "source": "host_clock",
                                   "workloads": ["dummy.cell"]})
    manifest["per_layer"].append({"name": "items_twice", "unit": "1",
                                  "better": "higher",
                                  "source": "program_counter",
                                  "layer": "dummy", "moves": "items_per_s",
                                  "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path


def _main(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "stub")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 1)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a: None)
    monkeypatch.setattr(sys, "path", [str(tree)] + sys.path)
    for name in [m for m in sys.modules if m.split(".")[0] == "benchmark"]:
        monkeypatch.delitem(sys.modules, name)
    spec = importlib.util.spec_from_file_location(
        "dummy_run", tree / "benchmark" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.mark.parametrize("trace", [0, 1])
def test_dummy_cell_runs_by_name(tree, monkeypatch, capsys, trace):
    main = _main(tree, monkeypatch)
    rc = main(["--workload", "dummy.cell", "--seed", "4294967296",
               "--seconds", "2", "--trace", str(trace)])
    out, err = capsys.readouterr()
    assert rc == 0
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert result["checks"] == {"gap": {"value": 0.5, "limit": 1.0}}
    assert err.strip().splitlines()[-1] == "check gap = 0.5 (limit 1.0)"
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert result["metrics"] == {"items_twice": {"value": 24.0,
                                                     "unit": "1"}}
        assert result["device"]["busy_s"] == pytest.approx(600e-9)
        assert result["device"]["window_s"] == pytest.approx(2000e-9)
        assert result["breakdown"]["device_ops"][0][0] in ("k_a", "k_b")
        assert result["breakdown"]["idle_gaps"][0][0] == "step"
    else:
        assert set(result["metrics"]) == {"items_per_s", "setup_s"}
        assert result["metrics"]["items_per_s"]["value"] == 6.0
