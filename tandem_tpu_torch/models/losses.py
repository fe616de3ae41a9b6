"""Per-stage masked depth losses.

Port of ``tandem_tpu/models/losses.py`` (parity target
cva_mvsnet/models/module.py:1170-1317). Every loss uses the reference's
normalisation: the mean over the full image divided by the mean of the
mask. Stage-dependent smooth-L1/berHu cutoffs: stage1 = 10/48, later 1e6.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

_STAGE_CUTOFF = {"stage1": 10.0 / 48, "stage2": 1e6, "stage3": 1e6}
STAGES = ("stage1", "stage2", "stage3")


def _masked_mean(x, mask):
    return torch.mean(x, dim=(1, 2)) / torch.mean(mask, dim=(1, 2))


def sl1_loss(est, gt, mask, stage=None):
    beta = _STAGE_CUTOFF.get(stage, 1e6)
    n = torch.abs(est * mask - gt * mask)
    loss = torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
    return _masked_mean(loss, mask)


def berhu_loss(est, gt, mask, stage=None):
    beta = _STAGE_CUTOFF.get(stage, 1e6)
    n = torch.abs(est * mask - gt * mask)
    loss = torch.where(n < beta, n, 0.5 * (n * n + beta * beta) / beta)
    return _masked_mean(loss, mask)


def l1_depth_loss(est, gt, mask, stage=None):
    return _masked_mean(torch.abs(est * mask - gt * mask), mask)


def abs_rel_loss(est, gt, mask, stage=None, eps: float = 0.01):
    return _masked_mean(mask * torch.abs(est - gt) / (gt + eps), mask)


def _grad_img(x, delta: int):
    """Scale-invariant gradient image (DeepTAM eq. 12, module.py:1254-1265)."""
    x_shift = F.pad(x[:, :, delta:], (0, delta))
    y_shift = F.pad(x[:, delta:, :], (0, 0, 0, delta))
    gx = x - x_shift
    gy = x - y_shift
    denom = torch.abs(gx) + torch.abs(gy) + 1e-6
    return torch.stack([gx / denom, gy / denom], dim=1)  # (B, 2, H, W)


def grad_loss(est, gt, mask, stage=None):
    total = 0.0
    for h in (1, 2, 4):
        g_gt = _grad_img(gt, h)
        g_est = _grad_img(est, h)
        norm = torch.linalg.vector_norm(g_est - g_gt, dim=1) * mask
        total = total + torch.mean(norm, dim=(1, 2)) / torch.mean(
            mask, dim=(1, 2))
    return total / 3.0


_LOSS_FNS = {"sl1": sl1_loss, "berhu": berhu_loss, "l1_depth": l1_depth_loss,
             "abs_rel": abs_rel_loss, "grad": grad_loss}


def compute_loss(outputs: Dict[str, Dict[str, torch.Tensor]], batch: dict,
                 weights: Tuple[float, ...] = (1.0, 1.0, 1.0),
                 loss_terms: Tuple[str, ...] = ("l1_depth",),
                 term_weights: Tuple[float, ...] = (1.0,),
                 keep_batch: bool = False):
    """:return: (total_loss scalar, dict of named losses).

    batch needs 'depth'[stage] and 'mask'[stage] (or 'mask_total'[stage]).
    """
    totals = {name: 0.0 for name in loss_terms}
    mask_key = "mask_total" if "mask_total" in batch else "mask"
    for i, stage in enumerate(STAGES):
        est = outputs[stage]["depth"]
        gt = batch["depth"][stage]
        mask = batch[mask_key][stage]
        for tw, name in zip(term_weights, loss_terms):
            loss = _LOSS_FNS[name](est, gt, mask, stage=stage)
            if not keep_batch:
                loss = torch.mean(loss)
            totals[name] = totals[name] + tw * weights[i] * loss
    total = 0.0
    losses = {}
    for name in loss_terms:
        totals[name] = totals[name] / sum(weights)
        losses[name + "_loss"] = totals[name]
        total = total + totals[name]
    losses["total_loss"] = total
    return total, losses
