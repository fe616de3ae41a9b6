"""Probe: the plane-sweep sample's backward kernel (``warp_sample_grad``)
against the sharing of its sweeps, at the abl04 640x480 stage shapes.

For each stage and dtype, three sweeps of the golden pack's view 0 <- 1
(``chip_smoke._golden_sweep``): the sweep itself (a small baseline: the
planes of one pixel land on a few source cells), the sweep with the source
camera moved forward by the median hypothesis (half of it behind the
camera, the rest spread wide), and both as one B = 2 call, as training
gives it. Each is timed with CUDA events (median of 50 calls, the zeroing
included) and by the profiler's device time, beside its kept samples and
their cells (how many samples hit a touched source cell, on average and at
most) and the atomics each design issues on it (``atomics``): one float32
atomicAdd a channel, live sample and corner for a design with one thread a
sample, against one vector atomic a run of a pixel's planes on one cell,
corner and channel vector for the kernel's register runs. At stage 1 the
B = 2 call is also timed at other planes a thread than ``grad_tiling``'s.
Needs a card; run from the root of a checkout:

    python -m tandem_tpu_torch.experiments.grad_contention
"""

from __future__ import annotations

import torch

from ..ops import bilinear_sample as bs
from ..ops.bilinear_sample import sweep_positions
from ..utils.cuda_timing import card_label, cuda_ms, require_cuda

# Planes a thread timed at stage 1 besides grad_tiling's choice.
STAGE1_PLANES = (8, 12, 16, 24, 48)


def _samples(mat, depth, H: int, W: int):
    """Each sample's clamped cell (x0 + 1) + (y0 + 1) * 65536, as the
    kernel keys it, and the corners that lie in the image with a weight
    other than 0 (bits 0-3, as ``corner_bits``), in float32 weights."""
    px, py, z = sweep_positions(mat, depth, H, W)
    x0, y0 = px.floor(), py.floor()
    inside = ~(z < 0.001) & (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) \
        & (y0 <= H - 1)
    wx1, wy1 = px - x0, py - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    x0in, x1in = x0 >= 0, x0 + 1 < W
    y0in, y1in = y0 >= 0, y0 + 1 < H
    bits = torch.zeros_like(px, dtype=torch.int64)
    for k, (xin, yin, w) in enumerate(((x0in, y0in, wx0 * wy0),
                                       (x1in, y0in, wx1 * wy0),
                                       (x0in, y1in, wx0 * wy1),
                                       (x1in, y1in, wx1 * wy1))):
        bits |= (inside & xin & yin & (w != 0)).long() << k
    xy = (x0.clamp(-1, W - 1).long() + 1) + (y0.clamp(-1, H - 1).long()
                                             + 1) * 65536
    return xy, bits


def cells(mat, depth, H: int, W: int) -> dict:
    """Kept samples (in front of the source camera with a corner in its
    image), touched cells and samples a touched cell (mean, max), per
    batch item summed."""
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


def atomics(mat, depth, H: int, W: int, C: int, vec: int,
            planes: int) -> dict:
    """The atomics each design issues on a sweep. ``per_sample``: one
    float32 atomicAdd a channel of each corner in the image with a weight
    of a live sample. ``runs``: the kernel's register runs (a thread walks
    ``planes`` consecutive planes of one pixel and channel vector; a run
    ends where a live sample's cell differs from the run's), one vector
    atomic of ``vec`` channels a corner a run touched and channel vector;
    ``runs_scalar`` counts them in float32 channels."""
    xy, bits = _samples(mat, depth, H, W)
    B, D = xy.shape[:2]
    xy = xy.permute(0, 2, 3, 1).reshape(-1, D)      # (pixels, D)
    bits = bits.permute(0, 2, 3, 1).reshape(-1, D)
    live = bits != 0
    k = torch.arange(D, device=xy.device).expand_as(xy)
    last = torch.cummax(torch.where(live, k, -1), dim=1).values
    prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
    start = k // planes * planes
    new = live & ((prev < start)
                  | (xy != xy.gather(1, prev.clamp(min=0))))
    run = torch.cumsum(new.flatten(), 0) - 1       # a live sample's run
    n_runs = int(new.sum())
    corners = 0
    for c in range(4):
        bit = ((bits.flatten() >> c) & 1)[live.flatten()]
        hit = torch.zeros(n_runs, dtype=torch.int64, device=xy.device)
        hit.scatter_reduce_(0, run[live.flatten()], bit, "amax")
        corners += int(hit.sum())
    popcount = sum(int(((bits >> c) & 1).sum()) for c in range(4))
    return {"per_sample": popcount * C, "runs": corners * (C // vec),
            "runs_scalar": corners * C, "planes": planes, "vec": vec}


def main() -> dict:
    """Return {(dtype, stage, sweep, planes): {"ms": ..., cells,
    atomics}}."""
    from chip_smoke import STAGE_SHAPES, _device_ms, _golden_sweep
    dev = require_cuda()
    print(f"[grad_contention] {card_label()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = bs._sm_count(dev.index or 0)
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
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
                vec = bs._grad_vec(C, gout.element_size(), gout.data_ptr())
                chosen = bs.grad_tiling(B, D, H, W, C // vec, sms)
                tried = STAGE1_PLANES if stage == "stage1" \
                    and name == "both" else (chosen,)
                for planes in tried:
                    def kernel():
                        return bs._grad_call(gout, mat, depth, 0.001, vec,
                                             planes)
                    r = {"ms": cuda_ms(kernel, iters=50),
                         "device_ms": _device_ms(kernel),
                         **cells(mat, depth, H, W),
                         **atomics(mat, depth, H, W, C, vec, planes)}
                    key = (dn, stage, name, planes)
                    res[key] = r
                    print(f"[grad_contention] {stage} {dn} {name} B={B} "
                          f"D={D} {W}x{H} C={C} planes {planes}"
                          f"{' (grad_tiling)' if planes == chosen else ''}"
                          f": {r['ms']:.4f} ms events, "
                          f"{r['device_ms']:.4f} ms device; {r['kept']} "
                          f"kept samples on {r['cells']} cells, "
                          f"{r['per_cell']:.2f} a touched cell (max "
                          f"{r['max_per_cell']}); atomics: one a sample "
                          f"{r['per_sample']:,} scalar, runs "
                          f"{r['runs']:,} of {vec} channels "
                          f"({r['runs_scalar']:,} scalar)", flush=True)
    return res


if __name__ == "__main__":
    main()
