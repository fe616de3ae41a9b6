"""Probe: the bilinear index + weight chain, kernel against plain PyTorch.

Torch counterpart of ``experiments/bench_idxchain.py`` (P5
``make_pallas``): positions x, y as (n, 128) float32 with n*128 =
32*240*320 samples (x uniform in [-2, W+1), y in [-2, H+1), so every
in-bounds case and both pad edges occur) -> packed-corner rows (n, 128)
int32 and four weights, here as one (4, n, 128) bf16 tensor. The kernel
is checked exactly against the plain chain, then both are timed with
CUDA events.

    python -m tandem_tpu_torch.experiments.idxchain_probe
"""

from __future__ import annotations

import torch

from ..ops.bilinear_index import bilinear_index, bilinear_index_plain
from ..utils.cuda_timing import card_label, cuda_ms, rate, require_cuda

H, W, D = 240, 320, 32
N = D * H * W


def main(n: int = N, iters: int = 10) -> tuple:
    """Run the probe; return (kernel_ms, plain_ms)."""
    dev = require_cuda()
    label = card_label()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = (torch.rand(n // 128, 128, generator=gen, device=dev)
         * (W + 3.0) - 2.0)
    y = (torch.rand(n // 128, 128, generator=gen, device=dev)
         * (H + 3.0) - 2.0)
    bf16 = torch.bfloat16
    got = bilinear_index(x, y, H, W, dtype=bf16)
    ref = bilinear_index_plain(x, y, H, W, dtype=bf16)
    ok = all(torch.equal(a, b) for a, b in zip(got, ref))
    print(f"idxchain n={n}: kernel vs plain chain "
          f"{'exact' if ok else 'WRONG'}", flush=True)
    if not ok:
        raise AssertionError("bilinear_index differs from the plain chain")
    ms = cuda_ms(lambda: bilinear_index(x, y, H, W, dtype=bf16), iters)
    pms = cuda_ms(lambda: bilinear_index_plain(x, y, H, W, dtype=bf16),
                  iters)
    print(f"idxchain n={n}: kernel {ms:8.4f} ms ({rate(n, ms):8.1f} M "
          f"rows/s), plain {pms:8.4f} ms ({rate(n, pms):8.1f} M rows/s) "
          f"[{label}]", flush=True)
    return ms, pms


if __name__ == "__main__":
    main()
