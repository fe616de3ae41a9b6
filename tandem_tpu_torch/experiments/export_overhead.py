"""Probe: where does a forward of the exported program (model.pt2) spend its
time against the eager f32 model it was exported from?

On the card, the trained abl04 unit (exported/tandem: 640x480, V = 7,
48/4/4 planes) is exported with ``cli/tandem_export.export_program`` and
loaded back; then, in turns (eager, program, program, eager), the stage-3
forward on the golden window is timed by the host clock (synced, median
of 10 after a warm-up) and by its enqueue time (the host clock until the
call returns, without a sync: no op of the forward waits for the card),
and one call of each is profiled: the device's busy time (the sum of its
kernels' times), its kernels, and the aten ops the host dispatched. Needs
a card; run from the root of a checkout:

    python -m tandem_tpu_torch.experiments.export_overhead
"""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from ..utils.cuda_timing import card_label, require_cuda

UNIT = Path("exported/tandem")


def _dispatched(fn) -> int:
    """The aten ops the host dispatches in one call of ``fn``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.n


def _profile(fn) -> dict:
    """One call under torch.profiler: the device's busy ms and kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    device = [e for e in p.key_averages()
              if e.device_type == DeviceType.CUDA]
    return {"device_busy_ms": sum(e.self_device_time_total
                                  for e in device) / 1e3,
            "device_kernels": sum(e.count for e in device)}


def _times(fn, reps: int = 10) -> dict:
    """Host ms of a synced call and of its enqueue, medians of ``reps``."""
    fn()
    torch.cuda.synchronize()
    wall, enqueue = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        enqueue.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    return {"wall_ms": float(np.median(wall)),
            "enqueue_ms": float(np.median(enqueue))}


def main() -> dict:
    from ..cli import tandem_export as te
    from ..models.convert import load_variables
    from ..models.cva_mvsnet import Stage3Forward
    dev = require_cuda()
    label = card_label()
    cfg = json.loads((UNIT / "model_config.json").read_text())
    pack = np.load(UNIT / "sample_inputs.npz")
    _, V, _, H, W = pack["image"].shape
    args = SimpleNamespace(
        width=W, height=H, view_num=V, device=dev.type,
        depth_num=",".join(str(d) for d in cfg["depth_num"]),
        view_aggregation=cfg["view_aggregation"],
        discard_percentage=float(pack["discard_percentage"]))
    variables = load_variables(UNIT / "model_variables.pkl")
    with tempfile.TemporaryDirectory() as out:
        te.export_program(variables, pack, args, str(Path(out) / te.PROGRAM))
        module = te.load_program(out)[0].module()
    eager = Stage3Forward(te._load_model(variables,
                                         te._model_kwargs_from_args(args),
                                         dev))
    x = te.program_inputs(pack, args.discard_percentage, dev)
    forwards = {"eager": lambda: eager(*x), "program": lambda: module(*x)}
    res = {"card": label}
    with torch.no_grad():
        for i, name in enumerate(("eager", "program", "program", "eager")):
            r = _times(forwards[name])
            r.update(_profile(forwards[name]))
            r["aten_ops"] = _dispatched(forwards[name])
            res[f"{i} {name}"] = r
            print(f"[export_overhead] {name}: {json.dumps(r)} ({label})",
                  flush=True)
    return res


if __name__ == "__main__":
    main()
