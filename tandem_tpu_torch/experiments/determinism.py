"""Probe: is the trained unit's f32 forward deterministic on the card, which
op varies if not, and what does pinning it cost?

For each setting (cuDNN free to pick any algorithm; ``cudnn.deterministic``;
``torch.use_deterministic_algorithms``), the golden pack's 640x480 forward
runs three times in this process: the sha256 digest of the 12 outputs'
bytes of each run, the first aten op (in call order, by a dispatch trace)
whose output differs between two runs, the host-clock ms of a runner
keyframe (``call_async`` + ``get_result``, synced, median of 5) and the
device busy time of one keyframe (torch.profiler), with its largest kernels.
Run it twice, in two processes, to compare digests across processes.
Needs a card; run from the root of a checkout:

    python -m tandem_tpu_torch.experiments.determinism
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

# Before CUDA starts: cuBLAS needs a fixed workspace to be deterministic.
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ..utils.cuda_timing import card_label, require_cuda  # noqa: E402
from ..utils.digest import digest  # noqa: E402

UNIT = Path("exported/tandem")
SETTINGS = ("free", "cudnn.deterministic", "use_deterministic_algorithms")


def _apply(setting: str):
    torch.backends.cudnn.deterministic = setting != "free"
    torch.use_deterministic_algorithms(
        setting == "use_deterministic_algorithms")


def _checksum(t) -> torch.Tensor:
    """An integer sum of a tensor's bit patterns, on its device."""
    words = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
    return torch.sum(t.detach().contiguous().view(words[t.element_size()]),
                     dtype=torch.int64)


def _traced_run(model, args) -> list:
    """Run the forward under a dispatch mode that records every aten op on
    the card with a checksum of its output; return [(op and its input
    shapes, checksum)] in call order. The port's own kernels do not
    dispatch: a difference that starts at one shows in the first op that
    reads its output."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Trace(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            shapes = [tuple(a.shape) for a in args
                      if isinstance(a, torch.Tensor)]
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.is_cuda and t.numel():
                    self.seen.append((f"{func} {shapes}", _checksum(t)))
            return out

    with Trace() as trace:
        model(*args)
    return [(op, int(c)) for op, c in trace.seen]


def main() -> dict:
    from ..models.convert import load_variables
    from ..models.cva_mvsnet import CvaMVSNet
    from ..pipeline.mvsnet_runner import MvsnetRunner
    dev = require_cuda()
    print(f"[determinism] {card_label()} torch {torch.__version__} cudnn "
          f"{torch.backends.cudnn.version()}", flush=True)
    cfg = json.loads((UNIT / "model_config.json").read_text())
    pack = np.load(UNIT / "sample_inputs.npz")
    V, H, W = (pack["image"].shape[i] for i in (1, 3, 4))
    runner = MvsnetRunner(CvaMVSNet(**cfg),
                          load_variables(UNIT / "model_variables.pkl"),
                          H, W, view_num=V, device=dev)
    model = runner.model
    args = (torch.from_numpy(pack["image"].astype(np.float32) / 255.0).to(dev),
            [torch.from_numpy(pack[k]).to(dev) for k in ("K1", "K2", "K3")],
            torch.from_numpy(pack["cam_to_world"]).to(dev),
            torch.from_numpy(pack["depth_min"]).to(dev),
            torch.from_numpy(pack["depth_max"]).to(dev),
            torch.full((1,), float(pack["discard_percentage"])))
    # The pack's views as a runtime window: ref-first back to ref = V - 2,
    # RGB back to BGR.
    order = list(range(1, V - 1)) + [0, V - 1]
    bgrs = [np.ascontiguousarray(pack["image"][0, i].transpose(1, 2, 0)
                                 [..., ::-1]) for i in order]
    poses = [pack["cam_to_world"][0, i] for i in order]
    K, dmin, dmax = (pack["K3"][0], float(pack["depth_min"][0]),
                     float(pack["depth_max"][0]))

    def keyframe():
        runner.call_async(bgrs, poses, K, dmin, dmax)
        return runner.get_result(device=True)["depth"]

    res = {}
    for setting in SETTINGS:
        _apply(setting)
        try:
            digests = [digest(model(*args)) for _ in range(3)]
            first = n_ops = None
            if digests[0] != digests[1]:
                a, b = _traced_run(model, args), _traced_run(model, args)
                first = next(((x[0], i) for i, (x, y) in enumerate(zip(a, b))
                              if x[1] != y[1]), None)
                n_ops = len(a)
            ms = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                keyframe()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as p:
                keyframe()
                torch.cuda.synchronize()
            device = [e for e in p.key_averages()
                      if e.device_type == DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in device) / 1e3
            top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
            res[setting] = {
                "digests": digests, "equal_in_process": len(set(digests)) == 1,
                "first_differing_op": first, "ops": n_ops,
                "keyframe_ms_median": float(np.median(ms[1:])),
                "keyframe_device_ms": busy,
                "top_kernels": [(e.key[:90], e.count,
                                 e.self_device_time_total / 1e3)
                                for e in top]}
        except RuntimeError as e:          # an op with no deterministic form
            res[setting] = {"error": str(e)[:400]}
        print(f"[determinism] {setting}: {json.dumps(res[setting])}",
              flush=True)
    _apply("free")
    return res


if __name__ == "__main__":
    main()
