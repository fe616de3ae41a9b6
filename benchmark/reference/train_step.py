"""Plain training steps of CVA-MVSNet: the published loss (the masked L1
depth error of each stage, averaged over the stages), its gradient by
autograd through the plain model in training mode (``cva_mvsnet.py``), and
Adam (Kingma and Ba; eps 1e-8 outside the root) under the published
schedule: the learning rate decays linearly from LR to LR x the final
fraction over the run, after a warm-up of int(500 x 16 / batch) steps from
a third of it (TANDEM's cva_mvsnet/tandem.py:82-94). It imports nothing of
the program; the batches are built from the scene's own arrays, as the
files on disk hold them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .cva_mvsnet import STAGES, PlainCvaMVSNet

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def lr_at(step: int, base_lr: float, total_steps: int, final_fraction: float,
          warmup_steps: int, warmup_factor: float = 1.0 / 3) -> float:
    """The schedule's learning rate at ``step`` (float32 arithmetic)."""
    f32 = np.float32
    s = f32(step)
    frac = min(s / f32(max(total_steps - 1, 1)), f32(1.0))
    factor = f32(1.0) * (f32(1) - frac) + f32(final_fraction) * frac
    if warmup_steps > 0 and step < warmup_steps:
        alpha = min(s / f32(warmup_steps), f32(1.0))
        factor = factor * (f32(warmup_factor) * (f32(1) - alpha) + alpha)
    return float(f32(base_lr) * factor)


def stage_K(K: np.ndarray, width: int, height: int, scale: float):
    """A camera resized by ``scale`` with its centre kept (pixel centres at
    integer coordinates)."""
    w, h = width * scale, height * scale
    out = np.array(K, np.float32, copy=True)
    out[0, 0] *= scale
    out[1, 1] *= scale
    out[0, 2] = 0.5 * (w - 1) + scale * (K[0, 2] - 0.5 * (width - 1))
    out[1, 2] = 0.5 * (h - 1) + scale * (K[1, 2] - 0.5 * (height - 1))
    return out


def make_batch(rgbs, depth_units, depth_scale: float, poses, tuples,
               K: np.ndarray, depth_min: float, depth_max: float, device):
    """The batch of the given view tuples: the reference view (the second
    newest) first, images in [0, 1], the ground-truth depth of each stage
    (the reference view's, every 4th / 2nd pixel) and its mask."""
    V = len(tuples[0])
    ref = V - 2
    order = [ref] + [i for i in range(V) if i != ref]
    H, W = rgbs.shape[1:3]
    img = np.stack([np.stack([rgbs[t[i]] for i in order])
                    for t in tuples]).astype(np.float32)
    img /= np.float32(255.0)      # on the host: an exact division
    image = torch.from_numpy(img.transpose(0, 1, 4, 2, 3).copy()).to(device)
    c2w = torch.from_numpy(np.stack([np.stack([poses[t[i]] for i in order])
                                     for t in tuples]).astype(np.float32))
    d = torch.from_numpy(np.stack([depth_units[t[ref]].astype(np.float32)
                                   for t in tuples])).to(device) * depth_scale
    depth, mask = {}, {}
    for stage, step in zip(STAGES, (4, 2, 1)):
        ds = d[:, ::step, ::step]
        m = (ds >= depth_min) & (ds <= depth_max)
        depth[stage] = torch.where(m, ds, torch.zeros_like(ds))
        mask[stage] = m.float()
    B = len(tuples)
    Ks = [torch.from_numpy(stage_K(K, W, H, s)).expand(B, 3, 3).to(device)
          for s in (0.25, 0.5, 1.0)]
    return {"image": image, "cam_to_world": c2w.to(device), "Ks": Ks,
            "depth": depth, "mask": mask,
            "depth_min": torch.full((B,), depth_min, device=device),
            "depth_max": torch.full((B,), depth_max, device=device)}


def l1_loss(out: dict, batch: dict) -> torch.Tensor:
    """Per stage and item: sum |est m - gt m| / sum m over the image (the
    means' ratio); the mean over the items, the mean over the stages."""
    total = 0.0
    for stage in STAGES:
        est = out[stage][0]
        gt, m = batch["depth"][stage], batch["mask"][stage]
        per = (torch.abs(est * m - gt * m).mean((1, 2))
               / m.mean((1, 2)))
        total = total + per.mean()
    return total / len(STAGES)


def train_steps(params: Dict[str, torch.Tensor], config: dict,
                batches: Sequence[dict], lrs: Sequence[float],
                quant: str = "none"):
    """Adam steps of the plain model from ``params`` (flax paths; the
    ``params/`` entries are trained). Returns (the loss of each step, the
    first step's gradient, each trained leaf's change after the steps)."""
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items() if k.startswith("params/")}
    model = PlainCvaMVSNet({**params, **leaves}, config, quant, train=True)
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    losses: List[float] = []
    first = None
    b1, b2 = BETAS
    for t, (batch, lr) in enumerate(zip(batches, lrs), 1):
        out = model.cascade(batch["image"], batch["Ks"],
                            batch["cam_to_world"], batch["depth_min"],
                            batch["depth_max"])
        loss = l1_loss(out, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if first is None:
                first = {k: g.clone() for k, g in zip(leaves, grads)}
            for (k, p), g in zip(leaves.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(ADAM_EPS)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        del out, loss, grads
    change = {k: p.detach() - params[k] for k, p in leaves.items()}
    return losses, first, change


def norm_gap(program: Dict[str, torch.Tensor],
             reference: Dict[str, torch.Tensor],
             rule: Dict[str, torch.Tensor]) -> float:
    """The worst leaf's gap between the program's and the reference's
    norms, over the larger of the reference leaf's norm and the median
    leaf's. Leaves whose reference gradient (``rule``) is under a
    thousandth of the median leaf's are left out: they move by round-off
    alone (a bias before a BatchNorm)."""
    gnorm = {k: float(v.norm()) for k, v in rule.items()}
    med_g = float(np.median(list(gnorm.values())))
    keep = [k for k in reference if gnorm[k] >= 1e-3 * med_g]
    ref = {k: float(reference[k].norm()) for k in keep}
    med = float(np.median(list(ref.values())))
    return max(abs(float(program[k].norm()) - ref[k]) / max(ref[k], med)
               for k in keep)
