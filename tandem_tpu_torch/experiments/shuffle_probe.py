"""Probe: row gather in table-shaped chunks, kernel against plain PyTorch.

Torch counterpart of ``experiments/pallas_shuffle_probe.py`` (P4
``make_shuffle``): out[i] = tbl[idx[i]] for g chunks of m rows each,
first a small exact check (m = 1024, 16 lanes, g = 2), then the
plane-sweep table size (m = 241*321 = 77,361 rows, 16/64/128 bf16 lanes,
g = 8). On this card the chunking the Mosaic lowering needed is moot: the
whole (g*m,) index vector goes to one ``row_gather`` launch.

    python -m tandem_tpu_torch.experiments.shuffle_probe
"""

from __future__ import annotations

import torch

from ..ops.row_gather import row_gather, row_gather_plain
from ..utils.cuda_timing import card_label, cuda_ms, rate, require_cuda

M = 241 * 321
LANES = (16, 64, 128)
G = 8


def _tables(dev, gen, m: int, lanes: int, g: int):
    tbl = torch.randn(m, lanes, generator=gen, device=dev).to(torch.bfloat16)
    idx = torch.randint(0, m, (g * m,), generator=gen, device=dev,
                        dtype=torch.int32)
    return tbl, idx


def main(m: int = M, lanes=LANES, g: int = G, iters: int = 10) -> dict:
    """Run the probe; return {lanes: (kernel_ms, plain_ms)}."""
    dev = require_cuda()
    label = card_label()
    gen = torch.Generator(device=dev).manual_seed(0)
    tbl, idx = _tables(dev, gen, 1024, 16, 2)
    ok = torch.equal(row_gather(tbl, idx), row_gather_plain(tbl, idx))
    print(f"correctness m=1024 lanes=16: {'OK' if ok else 'WRONG'}",
          flush=True)
    if not ok:
        raise AssertionError("row_gather differs from tbl[idx] (m=1024)")
    res = {}
    for ln in lanes:
        tbl, idx = _tables(dev, gen, m, ln, g)
        if not torch.equal(row_gather(tbl, idx), row_gather_plain(tbl, idx)):
            raise AssertionError(f"row_gather differs, lanes={ln}")
        ms = cuda_ms(lambda: row_gather(tbl, idx), iters)
        pms = cuda_ms(lambda: row_gather_plain(tbl, idx), iters)
        res[ln] = (ms, pms)
        rows = g * m
        print(f"shuffle m={m} lanes={ln:3d}: kernel {ms:8.4f} ms "
              f"({rate(rows, ms):8.1f} M rows/s), plain {pms:8.4f} ms "
              f"({rate(rows, pms):8.1f} M rows/s) [{label}]", flush=True)
    return res


if __name__ == "__main__":
    main()
