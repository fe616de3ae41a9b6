"""Drive a cell's traffic without ``run.py``'s look for a card, at a size a
test run holds: the fault and control tests on the CPU and the card."""

from __future__ import annotations

import copy
import importlib
import math
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
# Cells whose driver, traffic and limits are in the benchmark but which
# BENCHMARK.json does not hold (PERF.md says why): the tests drive them
# from these entries.
PARKED = {"slam.abl04_640x480.handheld": {
    "name": "slam.abl04_640x480.handheld", "config": "abl04_640x480",
    "traffic": "handheld", "chips": 1}}


def run_cell(cell: str, device: str, width: int, height: int,
             seconds: float, seed: int, traffic: dict = None,
             control=(), fault=None, config: dict = None) -> dict:
    """One run of ``cell`` on ``device`` at width x height (the focal length
    scaled with the width); ``traffic`` overrides entries of the cell's
    traffic file, ``control`` names the configuration's controls put in
    the program's place, ``fault(runner, backend)`` breaks the timed path
    before the run; ``config`` overrides entries of the configuration.
    Returns {"correct", "checks", "outcome"}."""
    from benchmark import run
    from benchmark.traffic import common

    args = run.parse(["--workload", cell, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", "0"])
    load = run.load_manifest
    if cell in PARKED:
        run.load_manifest = lambda: dict(
            load(), workloads=load()["workloads"] + [PARKED[cell]])
    try:
        ctx = run.prepare(args, control)
    finally:
        run.load_manifest = load
    ctx.config = copy.deepcopy(ctx.config)
    ctx.config["image"] = {"width": width, "height": height,
                           "fx": 375.0 * width / 640,
                           "fy": 375.0 * width / 640}
    ctx.config.update(config or {})
    ctx.traffic = dict(ctx.traffic, **(traffic or {}))
    ctx.device = torch.device(device)
    ctx.t_start = time.time()
    build = common.build_map_path
    restore = []
    if device == "cpu":
        restore.append((torch.cuda, "synchronize", torch.cuda.synchronize))
        torch.cuda.synchronize = lambda *a, **k: None
    if fault is not None:
        def broken(*a, **k):
            runner, backend, scans = build(*a, **k)
            fault(runner, backend)
            return runner, backend, scans
        restore.append((common, "build_map_path", build))
        common.build_map_path = broken
    try:
        driver = importlib.import_module(
            f"benchmark.traffic.{ctx.traffic['driver']}")
        outcome = driver.run(ctx)
        outcome["release"]()
        checks = outcome["check"]()
    finally:
        for owner, name, value in restore:
            setattr(owner, name, value)
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    return {"correct": correct, "checks": {n: v for n, v, _ in checks},
            "outcome": outcome}


def scale_depth(factor: float):
    """The fault "an answer altered where it is produced": every MVSNet
    answer's depth scaled by ``factor`` as the runner returns it."""
    def fault(runner, backend):
        forward = runner._forward

        def altered(*inputs):
            out = forward(*inputs)
            return (out[0] * factor,) + tuple(out[1:])
        runner._forward = altered
    return fault


def shift_fusion(monkeypatch, metres: float):
    """The fault "a step that fuses at a wrong pose": every scan fused with
    its camera moved ``metres`` along x."""
    from tandem_tpu_torch.pipeline import backend
    for name in ("integrate", "integrate_culled"):
        fn = getattr(backend, name)

        def moved(cfg, vol, depth, color, K, c2w, *rest, fn=fn):
            c2w = c2w.clone()
            c2w[0, 3] += metres
            return fn(cfg, vol, depth, color, K, c2w, *rest)
        monkeypatch.setattr(backend, name, moved)
