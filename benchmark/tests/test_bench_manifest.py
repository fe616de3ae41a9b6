"""BENCHMARK.json against the benchmark's contract: its keys, names, units,
bounds and the files each entry is found by."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# widths a configuration may never cut
WIDTH_KEYS = ("feature_net_base_channels", "cost_volume_base_channels",
              "depth_num", "image", "views")


@pytest.fixture(scope="module")
def manifest():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(manifest["command"]) <= 32
    assert all(_line(w) for w in manifest["command"])
    assert manifest["command"][1].startswith(manifest["paths"][0] + "/")
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fit_a_full_check(manifest):
    """A full check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60 s,
    2 x 90 s a cell to compile and 1200 s spare, within 43200 s."""
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs(manifest):
    names = [c["name"] for c in manifest["configs"]]
    assert len(names) == len(set(names)) and 1 <= len(names) <= 24
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(manifest["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        with open(ROOT / c["file"]) as f:
            body = json.load(f)
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key)
            assert key not in WIDTH_KEYS and not key.endswith(("_dim",
                                                               "_rank"))


def test_workloads(manifest):
    cells = manifest["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    four = sum(c["chips"] == 4 for c in cells)
    assert four <= max(1, len(cells) // 4)
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(c["name"]) and NAME.match(c["traffic"])
        assert c["chips"] in (1, 4) and _line(c["why"])
        traffic = json.loads((BENCH / "workloads" /
                              f"{c['traffic']}.json").read_text())
        assert (BENCH / "traffic" / f"{traffic['driver']}.py").exists()
        assert (BENCH / "limits" / f"{c['name']}.json").exists()


def test_metrics(manifest):
    e2e, layer = manifest["end_to_end"], manifest["per_layer"]
    names = [m["name"] for m in e2e + layer]
    assert len(names) == len(set(names))
    cells = {c["name"] for c in manifest["workloads"]}
    assert "setup_s" in names and 1 <= len(e2e) <= 16
    assert 1 <= len(layer) <= 128
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in layer:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in e2e}
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in e2e + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    # each listed cell reports the metric the per-layer metric moves
    for m in layer:
        moved = next(e for e in e2e if e["name"] == m["moves"])
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells))
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    for c in cells:
        assert sum(c in e.get("workloads", cells) for e in e2e) >= 2
        assert any(c in m.get("workloads", cells) for m in layer)


def test_layer_names_are_consistent(manifest):
    """Metrics of one layer name it letter for letter the same."""
    by_file = {}
    for m in manifest["per_layer"]:
        key = m["layer"].split()[0]
        by_file.setdefault(key, set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_file.values()), by_file
