"""Time the cost regulariser's decoder step on the card at the main path's
shapes: the hand-written kernel (``ops/deconv3d.py``, one launch), the
eager step it replaces (cuDNN's transposed convolution under
``cudnn.deterministic``, then the BatchNorm, ReLU and skip as torch ops)
and cuDNN's convolution alone, each the device time of a call replayed
from a CUDA graph (median of 5 rounds of 10 calls), beside the step's
byte bound (input, skip and output moved once at 3.35 TB/s) and its
operation bound (the taps' multiply-adds at the card's rate in the
step's dtype); ``host`` is a call's CUDA-event time without the graph
(the custom op's dispatch where it exceeds the kernel). The steps and
their seeded inputs are the card tests' (``tests/torch_cases.py``
``decoder_steps``, recorded from each configuration's model). One line a
step, then each configuration's sums a keyframe (3 stages x 3 steps),
and the kernel's register report from the build. Needs a card and the
checkout's ``tests/``; run from the root of a checkout:

    python -m tandem_tpu_torch.experiments.deconv_timing [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from ..models.cva_mvsnet import CvaMVSNet, pin_f32_precision
from ..ops import _build
from ..ops.deconv3d import deconv_bn_relu_add
from ..utils.cuda_timing import card_label, cuda_ms, require_cuda

# The benchmark's two mapping configurations (tests/torch_cases.py
# DECONV_CONFIGS); the trained unit in float32 has abl04's shapes.
TIMED = ("abl04 bf16", "CasMVSNet f32")
PEAK_BYTES = 3.35e12
# The card's multiply-add rate in each dtype: bfloat16 on the tensor cores
# (dense), float32 on the CUDA cores (TF32 stays off).
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def eager_step(x, w, inv, off, skip, stride):
    """The step as the eager path runs it."""
    shape = (1, -1, 1, 1, 1)
    y = F.conv_transpose3d(x, w, None, stride, 1,
                           tuple(s - 1 for s in stride))
    return skip + F.relu(y * inv.reshape(shape) + off.reshape(shape))


def bounds_ms(step, dtype) -> tuple:
    """(byte bound, operation bound) of a step in ms, the operations at the
    card's rate in ``dtype``."""
    _, _, Ci, Co, (D, H, W), stride = step
    elem = torch.finfo(dtype).bits // 8
    cells = D * H * W
    moved = elem * (Ci * cells + 2 * Co * cells * 4 * stride[0])
    flops = 2 * 27 * Ci * Co * cells
    return 1e3 * moved / PEAK_BYTES, 1e3 * flops / PEAK_FLOPS[dtype]


def graph_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median device ms of one call of ``fn``: ``reps`` calls captured in
    one CUDA graph (so no host time between launches is counted), each
    replay timed with CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)[rounds // 2]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    require_cuda()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))
    from torch_cases import DECONV_CONFIGS, decoder_steps, step_inputs
    pin_f32_precision()
    dev = torch.device("cuda")
    result = {"card": card_label(), "steps": [], "per_keyframe": {}}
    print(result["card"])
    for name in TIMED:
        _, dtype, size, depth_num = DECONV_CONFIGS[name]
        dtype = getattr(torch, dtype)
        with torch.device("meta"):
            model = CvaMVSNet(depth_num=depth_num, dtype=dtype)
        sums = dict(kernel=0.0, eager=0.0, cudnn=0.0, bytes=0.0, flops=0.0,
                    bound=0.0)
        for step in decoder_steps(model, size):
            x, w, inv, off, skip = step_inputs(step, dtype, dev)
            stage, layer, stride = step[0], step[1], step[5]
            ms = {
                "kernel": graph_ms(lambda: deconv_bn_relu_add(
                    x, w, inv, off, skip, stride)),
                "eager": graph_ms(lambda: eager_step(x, w, inv, off, skip,
                                                     stride)),
                "cudnn": graph_ms(lambda: F.conv_transpose3d(
                    x, w, None, stride, 1, tuple(s - 1 for s in stride))),
                "host": cuda_ms(lambda: deconv_bn_relu_add(
                    x, w, inv, off, skip, stride), args.iters),
            }
            by, fl = bounds_ms(step, dtype)
            row = dict(config=name, stage=stage, step=layer,
                       input=list(step[4]), ci=step[2], co=step[3],
                       stride=list(stride), bytes_ms=by, flops_ms=fl, **ms)
            result["steps"].append(row)
            for k, v in ms.items():
                if k in sums:
                    sums[k] += v
            sums["bytes"] += by
            sums["flops"] += fl
            sums["bound"] += max(by, fl)
            print(f"{name} {stage} {layer} in {step[4]} ci {step[2]} co "
                  f"{step[3]} stride {stride}: "
                  + " ".join(f"{k} {v:.4f}" for k, v in ms.items())
                  + f" ms; bound bytes {by:.4f} flops {fl:.4f} ms",
                  flush=True)
            del x, w, inv, off, skip
        result["per_keyframe"][name] = sums
        share = 100 * sums["bound"] / sums["kernel"]
        print(f"{name} a keyframe: "
              + " ".join(f"{k} {v:.4f}" for k, v in sums.items())
              + f" ms; kernel share of the bound {share:.1f}%", flush=True)
    log = _build.library_path().parent / "ptxas.log"
    if log.exists():
        lines = log.read_text().splitlines()
        result["ptxas"] = [ln for i, ln in enumerate(lines) if any(
            "deconv" in x for x in lines[max(i - 2, 0):i + 1])]
        print("\n".join(result["ptxas"]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
