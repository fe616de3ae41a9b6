"""Probe: row gather and packed-corner gather + blend from a plane-sweep
sized table, kernel against plain PyTorch.

Torch counterpart of ``experiments/pallas_gather_probe.py``: the table is
the stage-2 source of the older (48, 32, 8) configuration, (241*321, 64)
bf16 (a 1-pixel padded 240x320 map, 4C = 64 packed-corner lanes, C = 16),
gathered at N = 65,536 and 2,457,600 (32*240*320) random rows. The three
Pallas kernels it probes map to two hand CUDA kernels: ``row_gather`` (P1
``make_pallas_sublane`` and P2 ``make_pallas_take``, one function) and
``corner_blend`` (P3 ``make_pallas_fused``, 4-weight blend to (N, C)).
Each is checked exactly against its plain version, then both are timed
with CUDA events.

    python -m tandem_tpu_torch.experiments.gather_probe
"""

from __future__ import annotations

import torch

from ..ops.corner_blend import corner_blend, corner_blend_plain
from ..ops.row_gather import row_gather, row_gather_plain
from ..utils.cuda_timing import card_label, cuda_ms, rate, require_cuda

M = 241 * 321            # table rows (padded 240x320 source)
CW = 64                  # packed 4C row width, C = 16
C = CW // 4
N_SMALL = 64 * 1024
N_FULL = 32 * 240 * 320  # 2.458M rows = stage-2 D*H*W


def main(sizes=(N_SMALL, N_FULL), m: int = M, iters: int = 20) -> dict:
    """Run the probe; return {name: {n: (kernel_ms, plain_ms)}}."""
    dev = require_cuda()
    label = card_label()
    gen = torch.Generator(device=dev).manual_seed(0)
    tbl = torch.randn(m, CW, generator=gen, device=dev).to(torch.bfloat16)
    res = {"row_gather": {}, "corner_blend": {}}
    for n in sizes:
        print(f"--- N = {n} rows, table ({m}, {CW}) bf16 ---", flush=True)
        idx = torch.randint(0, m, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        w = torch.rand(4, n, generator=gen, device=dev).to(torch.bfloat16)
        if not torch.equal(row_gather(tbl, idx), row_gather_plain(tbl, idx)):
            raise AssertionError(f"row_gather differs from tbl[idx], N={n}")
        if not torch.equal(corner_blend(tbl, idx, w),
                           corner_blend_plain(tbl, idx, w)):
            raise AssertionError(f"corner_blend differs from plain, N={n}")
        for name, kern, plain, args in (
                ("row_gather", row_gather, row_gather_plain, (tbl, idx)),
                ("corner_blend", corner_blend, corner_blend_plain,
                 (tbl, idx, w))):
            ms = cuda_ms(lambda: kern(*args), iters)
            pms = cuda_ms(lambda: plain(*args), iters)
            res[name][n] = (ms, pms)
            print(f"{name:12s} N={n:8d}: kernel {ms:8.4f} ms "
                  f"({rate(n, ms):8.1f} M rows/s), plain {pms:8.4f} ms "
                  f"({rate(n, pms):8.1f} M rows/s) [{label}]", flush=True)
    return res


if __name__ == "__main__":
    main()
