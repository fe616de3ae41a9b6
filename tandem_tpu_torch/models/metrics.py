"""Depth evaluation metrics (abs_rel, rmse, a1-a3, d1-d3, ...).

Port of ``tandem_tpu/models/metrics.py`` (parity target eval_errors,
cva_mvsnet/models/module.py:1364-1465): masked reductions, pixels with
mask <= 0.5 weigh zero.
"""

from __future__ import annotations

from typing import Dict

import torch

METRIC_NAMES = ("abs_rel", "abs", "sq_rel", "rmse", "rmse_log",
                "a1", "a2", "a3", "d1", "d2", "d3")
STAGES = ("stage1", "stage2", "stage3")


def _masked_mean(x, m, dim):
    denom = torch.clamp(torch.sum(m, dim=dim), min=1e-12)
    return torch.sum(x * m, dim=dim) / denom


def stage_errors(est, gt, mask, keep_batch: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """est, gt, mask: (B, H, W). Returns dict of (B,) or scalar metrics."""
    m = (mask > 0.5).to(torch.float32)
    dim = (1, 2)
    one = torch.ones((), dtype=gt.dtype, device=gt.device)
    gt_safe = torch.where(m > 0, gt, one)
    est_safe = torch.where(m > 0, est, one)

    abs_diff = torch.abs(gt_safe - est_safe)
    abs_rel_img = abs_diff / gt_safe
    d_val = torch.maximum(gt_safe / est_safe, est_safe / gt_safe)

    def frac(x):
        return _masked_mean(x.to(torch.float32), m, dim)
    out = {
        "abs_rel": _masked_mean(abs_rel_img, m, dim),
        "abs": _masked_mean(abs_diff, m, dim),
        "sq_rel": _masked_mean((gt_safe - est_safe) ** 2 / gt_safe, m, dim),
        "rmse": torch.sqrt(_masked_mean((gt_safe - est_safe) ** 2, m, dim)),
        "rmse_log": torch.sqrt(_masked_mean(
            (torch.log(torch.clamp(gt_safe, min=1e-12))
             - torch.log(torch.clamp(est_safe, min=1e-12))) ** 2, m, dim)),
        "a1": frac(abs_rel_img < 0.1),
        "a2": frac(abs_rel_img < 0.1 ** 2),
        "a3": frac(abs_rel_img < 0.1 ** 3),
        "d1": frac(d_val < 1.25),
        "d2": frac(d_val < 1.25 ** 2),
        "d3": frac(d_val < 1.25 ** 3),
    }
    if not keep_batch:
        out = {k: torch.mean(v) for k, v in out.items()}
    return out


def eval_errors(outputs: dict, batch: dict, keep_batch: bool = False) -> dict:
    return {stage: stage_errors(outputs[stage]["depth"],
                                batch["depth"][stage], batch["mask"][stage],
                                keep_batch=keep_batch)
            for stage in STAGES}
