"""Training utilities: meters, epoch reductions, SAM, multi-step LR.

Port of ``tandem_tpu/train/utils.py`` (parity targets cva_mvsnet/utils.py
and models/utils/__init__.py): DictAverageMeter / epoch_end_mean (recursive
mean over step outputs, with per-dataset-name grouping),
StreamingBinCount, the WarmupMultiStepLR schedule
(models/utils/warmup_multi_step_lr.py) and SAM's first step
(module.py:1568-1629).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Sequence

import numpy as np
import torch


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().double().cpu().numpy()
    return np.asarray(v, np.float64)


def _tree_mean(items: Sequence[Any]):
    if isinstance(items[0], dict):
        return {k: _tree_mean([it[k] for it in items]) for k in items[0]}
    return float(np.mean([_to_numpy(v).mean() for v in items]))


def epoch_end_mean(outputs: List[Dict]) -> Dict:
    """Recursive mean over a list of per-step output dicts."""
    return _tree_mean(list(outputs))


def epoch_end_mean_named(outputs: List[Dict], names: List[str]):
    """Per-dataset-name means + overall mean (utils epoch_end_mean_named)."""
    overall = epoch_end_mean(outputs)
    grouped = defaultdict(list)
    for out, name in zip(outputs, names):
        key = name[0] if isinstance(name, (list, tuple)) else name
        grouped[key].append(out)
    per_name = {k: epoch_end_mean(v) for k, v in grouped.items()}
    return overall, per_name


class DictAverageMeter:
    def __init__(self):
        self.sums: Dict[str, float] = defaultdict(float)
        self.count = 0

    def update(self, values: Dict[str, float]):
        for k, v in values.items():
            self.sums[k] += float(_to_numpy(v))
        self.count += 1

    def mean(self) -> Dict[str, float]:
        return {k: v / max(self.count, 1) for k, v in self.sums.items()}


class StreamingBinCount:
    """Streaming histogram (models/utils/__init__.py StreamingBinCount)."""

    def __init__(self, bins: int, lo: float = 0.0, hi: float = 1.0):
        self.edges = np.linspace(lo, hi, bins + 1)
        self.counts = np.zeros(bins, np.int64)

    def update(self, values):
        h, _ = np.histogram(_to_numpy(values).reshape(-1), bins=self.edges)
        self.counts += h

    def normalized(self):
        total = max(self.counts.sum(), 1)
        return self.counts / total


def warmup_multi_step_lr(base_lr: float, milestones: Sequence[int],
                         gamma: float = 0.5, warmup_factor: float = 1.0 / 3,
                         warmup_iters: int = 500):
    """WarmupMultiStepLR: linear warmup then step decay at milestones;
    float32 arithmetic, as the JAX package computes it."""
    ms = np.asarray(sorted(milestones))
    f32 = np.float32

    def fn(step):
        alpha = min(f32(step) / f32(max(warmup_iters, 1)), f32(1.0))
        wf = f32(warmup_factor) * (f32(1) - alpha) + alpha
        decay = f32(gamma) ** f32(np.sum(step >= ms))
        return float(f32(base_lr) * wf * decay)
    return fn


@torch.no_grad()
def sam_perturb(params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor], rho: float = 0.05):
    """SAM's first step: the worst-case offsets e_w = rho g / ||g||, with
    ||g|| the global norm over all parameter tensors (optax.global_norm).
    Returns the offsets; the caller adds them to the parameters, takes the
    gradient there and restores the parameters (trainer.make_train_step).
    """
    gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
    scale = rho / (gnorm.float() + 1e-12)
    return [scale * g for g in grads]
