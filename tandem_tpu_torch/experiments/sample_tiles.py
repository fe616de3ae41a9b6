"""Probe: the plane-sweep sample kernel's tiling, at the abl04 640x480
stage shapes in f32 and bf16.

For each (rows a block, planes a warp) setting of
``csrc/bilinear_sample.cu`` (the wrapper picks one with
``ops/bilinear_sample.sweep_tiling``) the kernel is checked against
``warp_sample_plain`` (torch.equal) on the golden pack's view 0 <- 1 sweep
(``chip_smoke._golden_sweep``) and timed with CUDA events around bare
ctypes launches (no wrapper: the host issues faster than the card runs
even the 12 µs stage-2 sweep), median of 5 rounds of 20. Needs a card;
run from the root of a checkout:

    python -m tandem_tpu_torch.experiments.sample_tiles
"""

from __future__ import annotations

import torch

from ..ops import _build
from ..ops import bilinear_sample as bs
from ..ops.corner_blend import _vec
from ..utils.cuda_timing import card_label, cuda_ms, require_cuda

ROWS = (1, 2, 4, 8)
PLANES = (1, 2, 4)


def main() -> dict:
    """Return {(dtype, stage): {(rows, planes): ms}}."""
    from chip_smoke import STAGE_SHAPES, _golden_sweep
    dev = require_cuda()
    print(f"[sample_tiles] {card_label()}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    fn = _build.kernels().tandem_warp_sample
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        for stage, (D, H, W, C) in STAGE_SHAPES.items():
            feat = torch.randn((1, H, W, C), generator=gen,
                               device=dev).to(dtype)
            mat, depth, _ = _golden_sweep(dev, stage, D, H, W)
            ref = bs.warp_sample_plain(feat, mat, depth)
            out = torch.empty_like(ref)
            times = {}
            for rows in ROWS:
                for planes in PLANES:
                    args = (bs._SWEEP_ARGS.pack(
                        feat.data_ptr(), mat.data_ptr(), depth.data_ptr(),
                        out.data_ptr(), 1, D, H, W, C,
                        _vec(C, feat.element_size(), feat.data_ptr()), rows,
                        planes, int(dtype == torch.bfloat16), 0.001), stream)
                    out.zero_()
                    if fn(*args) != 0 or not torch.equal(out, ref):
                        raise AssertionError(f"{stage} {dtype} rows {rows} "
                                             f"planes {planes}: not exact")
                    times[(rows, planes)] = cuda_ms(lambda: fn(*args),
                                                    iters=100)
            best = min(times, key=times.get)
            vec = _vec(C, feat.element_size(), feat.data_ptr())
            chosen = bs.sweep_tiling(1, D, H, W, C // vec, bs._sm_count(
                dev.index or 0))
            dn = str(dtype).split(".")[-1]
            print(f"[sample_tiles] {stage} {dn} D={D} {W}x{H} C={C}: exact "
                  "in every setting; ms (rows a block x planes a warp): "
                  + ", ".join(f"{r}x{p} {t:.4f}"
                              for (r, p), t in times.items())
                  + f"; best {best[0]}x{best[1]}, sweep_tiling's "
                  f"{chosen[0]}x{chosen[1]} {times[chosen]:.4f}", flush=True)
            res[(dn, stage)] = times
    return res


if __name__ == "__main__":
    main()
