"""Run one cell of the benchmark of ``tandem_tpu_torch`` once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cards the cell asks for.
Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``benchmark/configs/<config>.json``), its traffic
(``benchmark/workloads/<traffic>.json``, whose ``driver`` names the
general generator ``benchmark/traffic/<driver>.py``), the limits of its
correctness check (``benchmark/limits/<cell>.json``) and, with
``--trace 1``, one reader a per-layer metric
(``benchmark/metrics/<metric>.py``, whose ``read(trace)`` returns a number
or None). Adding a cell or a metric adds files and manifest entries; no
file here changes.

The last line of standard output is the result, one JSON object; the
numbers the correctness check compared, each beside its limit, are the
last lines of standard error and the result's last key. Without the cards
the cell asks for, or with JAX loaded once the window has closed, it exits
with a non-zero code and prints no result.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tandem_tpu")
# Build and kernel caches of the program and its libraries, at fixed paths
# inside the checkout, so only a checkout's first run builds.
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions",
              "TRITON_CACHE_DIR": ".bench_cache/triton"}


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def load_manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_metric(name: str, trace):
    """The per-layer metric's reader, found by name."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(trace)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare(args, control=()) -> SimpleNamespace:
    """The cell's files, by name; ``control`` names the configuration's
    controls (its ``controls``) that take the program's place."""
    manifest = load_manifest()
    cell = find(manifest["workloads"], args.workload, "workload")
    conf = find(manifest["configs"], cell["config"], "config")
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(BENCH / "workloads" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    with open(BENCH / "limits" / f"{cell['name']}.json") as f:
        limits = json.load(f)
    return SimpleNamespace(manifest=manifest, cell=cell, config=config,
                           traffic=traffic, limits=limits, root=ROOT,
                           seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), t_start=T_START,
                           control={c: config["controls"][c]
                                    for c in control or ()})


def metrics_of(ctx, outcome) -> dict:
    name = ctx.cell["name"]
    if not ctx.trace:
        return {m["name"]: {"value": outcome["e2e"][m["name"]],
                            "unit": m["unit"]}
                for m in ctx.manifest["end_to_end"] if applies(m, name)}
    out = {}
    for m in ctx.manifest["per_layer"]:
        if applies(m, name):
            v = read_metric(m["name"], outcome["trace"])
            if v is not None:
                out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def main(argv=None, control=()) -> int:
    """One run; with ``control`` (``benchmark/control.py``) the named
    controls of the configuration, each the plain reference (or the
    program's layer) in the precision below the configuration's, take the
    program's place in what is compared."""
    args = parse(sys.argv[1:] if argv is None else argv)
    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / rel)
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))
    ctx = prepare(args, control)

    import torch
    chips = ctx.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3
    ctx.device = torch.device("cuda", 0)
    driver = importlib.import_module(
        f"benchmark.traffic.{ctx.traffic['driver']}")
    outcome = driver.run(ctx)
    peak = torch.cuda.max_memory_allocated(ctx.device)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"JAX is loaded in the measuring process: {found}",
              file=sys.stderr)
        return 4
    metrics = metrics_of(ctx, outcome)
    outcome["release"]()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    checks = outcome["check"]()

    correct = True
    compared = {}
    for name, value, limit in checks:
        ok = math.isfinite(value) and value <= limit
        correct = correct and ok
        compared[name] = {"value": value, "limit": limit}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": outcome["attempted"],
              "failed": outcome["failed"], "metrics": metrics,
              "device": device}
    if ctx.trace:
        from benchmark.harness.tracing import busy_ns, make_breakdown
        tr = outcome["trace"]
        t0, t1 = tr.facts["t0_ns"], tr.facts["t1_ns"]
        device["busy_s"] = busy_ns(tr.kernels, t0, t1) / 1e9
        device["window_s"] = (t1 - t0) / 1e9
        result["breakdown"] = make_breakdown(tr.kernels, t0, t1,
                                             outcome["host_spans"])
    result["checks"] = compared
    found = forbidden_modules(sys.modules)
    if found:
        print(f"JAX is loaded in the measuring process: {found}",
              file=sys.stderr)
        return 4
    for name, c in compared.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
