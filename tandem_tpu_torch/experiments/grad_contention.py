"""Probe: how the plane-sweep sample's backward kernel (``warp_sample_grad``)
slows with the atomics' contention, at the abl04 640x480 stage shapes.

For each stage and dtype, three sweeps of the golden pack's view 0 <- 1
(``chip_smoke._golden_sweep``): the sweep itself (a small baseline: the
planes of one pixel land on a few source cells), the sweep with the source
camera moved forward by the median hypothesis (half of it behind the
camera, the rest spread wide), and both as one B = 2 call, as training
gives it. Each is timed with CUDA events (median of 50 calls, the zeroing
included) beside its kept samples and their cells: how many samples hit a
touched source cell, on average and at most (each such sample adds its C
channels to the cell's four corners with float32 atomics). Needs a card;
run from the root of a checkout:

    python -m tandem_tpu_torch.experiments.grad_contention
"""

from __future__ import annotations

import torch

from ..ops.bilinear_sample import sweep_positions, warp_sample_grad
from ..utils.cuda_timing import card_label, cuda_ms, require_cuda


def _cells(mat, depth, H: int, W: int) -> dict:
    """Kept samples, touched cells and samples a touched cell (mean, max)
    of a sweep, per batch item summed."""
    px, py, z = sweep_positions(mat, depth, H, W)
    keep = ~(z < 0.001) & (px > -1) & (px < W) & (py > -1) & (py < H)
    cell = ((py.floor().clamp(-1, H) + 1) * (W + 2)
            + px.floor().clamp(-1, W) + 1)
    kept, touched, worst = 0, 0, 0
    for b in range(px.shape[0]):
        n = torch.bincount(cell[b][keep[b]].long().flatten(),
                           minlength=(H + 2) * (W + 2))
        kept += int(n.sum())
        touched += int((n > 0).sum())
        worst = max(worst, int(n.max()))
    return {"kept": kept, "cells": touched,
            "per_cell": kept / max(touched, 1), "max_per_cell": worst}


def main() -> dict:
    """Return {(dtype, stage, sweep): {"ms": ..., cells}}."""
    from chip_smoke import STAGE_SHAPES, _golden_sweep
    dev = require_cuda()
    print(f"[grad_contention] {card_label()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        for stage, (D, H, W, C) in STAGE_SHAPES.items():
            sweeps = {"golden": _golden_sweep(dev, stage, D, H, W)[:2],
                      "behind": _golden_sweep(dev, stage, D, H, W, True)[:2]}
            sweeps["both"] = tuple(
                torch.cat([sweeps["behind"][i], sweeps["golden"][i]])
                .contiguous() for i in range(2))
            for name, (mat, depth) in sweeps.items():
                B = mat.shape[0]
                gout = torch.randn((B, D, H, W, C), generator=gen,
                                   device=dev).to(dtype)
                ms = cuda_ms(lambda: warp_sample_grad(gout, mat, depth),
                             iters=50)
                r = {"ms": ms, **_cells(mat, depth, H, W)}
                res[(str(dtype).split(".")[-1], stage, name)] = r
                print(f"[grad_contention] {stage} {dtype} {name} B={B} "
                      f"D={D} {W}x{H} C={C}: {ms:.4f} ms; {r['kept']} kept "
                      f"samples on {r['cells']} cells, "
                      f"{r['per_cell']:.2f} a touched cell (max "
                      f"{r['max_per_cell']})", flush=True)
    return res


if __name__ == "__main__":
    main()
