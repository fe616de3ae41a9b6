"""Device timing on an NVIDIA GPU: CUDA-event kernel times and the card's
name and power limit, which every kept number carries. There is no CPU
path: a measurement that finds no card raises."""

from __future__ import annotations

import subprocess

import numpy as np
import torch


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs an NVIDIA GPU "
                           "(torch.cuda.is_available() is False)")
    return torch.device("cuda", torch.cuda.current_device())


def card_label() -> str:
    """``name, power.limit`` as nvidia-smi prints them for the first card
    (the runs here use one card, or cards of one kind)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median per-call device time of ``fn`` over ``iters`` launches, timed
    with CUDA events (5 rounds of iters // 5 calls each)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_round = max(iters // 5, 1)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_round):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_round)
    return float(np.median(times))


def rate(rows: int, ms: float) -> float:
    """Millions of rows per second."""
    return rows / (ms * 1e-3) / 1e6
