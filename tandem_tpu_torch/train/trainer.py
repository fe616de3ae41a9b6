"""Trainer of CVA-MVSNet, on one device or data-parallel over ranks.

Port of ``tandem_tpu/train/trainer.py:33-256``:

- ``lr_schedule``: linear decay from LR to LR * final_fraction over the
  total steps (tandem.py:87-94) with a warmup of int(500 * 16 / batch)
  steps (tandem.py:82-85), the same function of the step as the JAX
  package's, in float32;
- ``create_train_state``: the model with flax's initializers
  (variance_scaling(1, fan_in, truncated normal) for convolutions,
  variance_scaling(1/3, fan_in, uniform) for transposed ones, zero biases,
  BatchNorm at scale 1, bias 0, mean 0, var 1) drawn from an explicit
  ``torch.Generator``; Adam (eps 1e-8, optax's defaults) under a
  ``LambdaLR`` of the schedule; the LR scaled by the world size
  (train.py:70-72);
- ``make_train_step``: one optimizer step on a batch, with SAM's two
  passes when TRAIN.SAM is set (module.py:1568-1629, adaptive=False);
- ``make_eval_step``: the eval forward and the per-sample errors.

Data parallelism, the counterpart of the JAX ``data`` mesh: one process a
rank (``init_process_group``: NCCL on cards, gloo on the CPU or where
ranks share a card). Every rank builds, and augments, the same global
batch from the same seeds and keeps its rows (``shard_batch``, the JAX
"same global batch on every process" discipline); the training
BatchNorms take the global batch's statistics (``layers.batch_norm_train``);
after each backward the gradients are averaged over the ranks with one
flattened all-reduce, before SAM's perturbation (whose norm is then the
global gradient's) and before Adam; the loss and the metrics are rank
means, which equal the global batch's means as the shards have equal
sizes, so every rank holds them and reads them locally (what ``host_local``
does for the JAX package's replicated metrics). DDP's bucketed overlap of
the all-reduce with the backward is not used: one explicit average is
exact and countable.

A step leaves the BatchNorm running statistics where flax's mutable
``batch_stats`` would: updated by the (last) forward pass from the state's
statistics.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.cva_mvsnet import STAGES, CvaMVSNet, outputs_to_dict
from ..models.losses import compute_loss
from ..models.metrics import eval_errors
from ..parallel import collectives

# The keys of a batch that a step reads.
BATCH_KEYS = ("image", "cam_to_world", "depth_min", "depth_max",
              "intrinsics", "depth", "mask")
# flax's truncated normal draws in [-2, 2] and scales by this (the standard
# deviation of the unit normal truncated there) to keep the variance.
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class TrainState:
    model: CvaMVSNet
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def lr_schedule(base_lr: float, total_steps: int, final_fraction: float,
                warmup_steps: int = 0, warmup_factor: float = 1.0 / 3):
    """The LR at each step, as ``tandem_tpu.train.trainer.lr_schedule``
    computes it (float32 operations in its order)."""
    f32 = np.float32

    def fn(step: int) -> float:
        s = f32(step)
        frac = min(s / f32(max(total_steps - 1, 1)), f32(1.0))
        factor = f32(1.0) * (f32(1) - frac) + f32(final_fraction) * frac
        if warmup_steps > 0:
            alpha = min(s / f32(warmup_steps), f32(1.0))
            wfac = f32(warmup_factor) * (f32(1) - alpha) + alpha
            factor = factor * (wfac if step < warmup_steps else f32(1.0))
        return float(f32(base_lr) * factor)
    return fn


def model_from_config(config: Dict[str, Any]) -> CvaMVSNet:
    return CvaMVSNet(
        depth_num=tuple(config["MODEL.DEPTH_NUM"]),
        depth_interval_ratio=tuple(config["MODEL.DEPTH_INTERVAL_RATIO"]),
        feature_net_base_channels=config["MODEL.FEATURE_NET_BASE_CHANNELS"],
        cost_volume_base_channels=tuple(
            config["MODEL.COST_VOLUME_BASE_CHANNELS"]),
        view_aggregation=config["MODEL.VIEW_AGGREGATION"],
        dtype=torch.bfloat16 if config.get("TRAIN.COMPUTE_DTYPE")
        == "bfloat16" else torch.float32)


@torch.no_grad()
def init_parameters(model: nn.Module, gen: torch.Generator) -> None:
    """flax's initializers, drawn from ``gen`` module by module."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
            w = m.weight
            taps = math.prod(w.shape[2:])
            if isinstance(m, nn.ConvTranspose3d):   # (I, O, k, k, k)
                limit = math.sqrt(1.0 / (w.shape[0] * taps))
                draw = torch.rand(w.shape, generator=gen) * 2 - 1
                w.copy_(draw * limit)
            else:                                   # (O, I, k...)
                std = math.sqrt(1.0 / (w.shape[1] * taps)) / _TRUNC_STD
                draw = torch.empty(w.shape)
                nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0,
                                      generator=gen)
                w.copy_(draw * std)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()


def create_train_state(config: Dict[str, Any], gen: torch.Generator,
                       total_steps: int, world_size: int = 1,
                       device=None) -> Tuple[CvaMVSNet, TrainState]:
    """The model (initialized from ``gen``, on ``device``) and its Adam
    state under the LR schedule of the config."""
    model = model_from_config(config)
    init_parameters(model, gen)
    model.to(device)
    base_lr = config["TRAIN.LR"]
    if config.get("TRAIN.LR_DDP_SCALE_WITH_BATCH_SIZE", True):
        base_lr = base_lr * world_size
    batch_size = config["TRAIN.BATCH_SIZE"] * world_size
    warmup = int(500 * (16 / batch_size))
    sched = lr_schedule(base_lr, total_steps,
                        config["TRAIN.LR_SCHEDULE_FINAL_FRACTION"],
                        warmup_steps=warmup)
    optimizer = torch.optim.Adam(model.parameters(), lr=base_lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: sched(step) / base_lr)
    return model, TrainState(model, optimizer, scheduler)


def batch_to_device(batch: Dict, device) -> Dict:
    """The step's keys of a numpy batch as tensors on ``device``."""
    def put(v):
        if isinstance(v, dict):
            return {k: put(x) for k, x in v.items()}
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        return t.to(device, non_blocking=True)
    return {k: put(batch[k]) for k in BATCH_KEYS if k in batch}


def _stage_K(batch, stage):
    """Per-stage shared intrinsics: datasets stack one K per view
    (B, V, 3, 3) but all views share the camera; the model takes the
    shared (B, 3, 3)."""
    K = batch["intrinsics"][stage]["K"]
    return K[:, 0] if K.dim() == 4 else K


def forward_outputs(model: CvaMVSNet, batch: Dict, train: bool) -> Dict:
    outputs = model(batch["image"],
                    tuple(_stage_K(batch, s) for s in STAGES),
                    batch["cam_to_world"], batch["depth_min"],
                    batch["depth_max"], train=train)
    return outputs_to_dict(outputs)


def loss_config(config: Dict[str, Any]) -> Dict[str, Tuple]:
    return dict(weights=tuple(config["LOSS.STAGE_WEIGHTS"]),
                loss_terms=tuple(config["LOSS.TERMS"]),
                term_weights=tuple(config["LOSS.TERM_WEIGHTS"]))


def init_process_group(device: torch.device, init_method: str,
                       world: int, rank: int, backend: str = None):
    """Join the data-parallel ranks: NCCL when each rank has its own card,
    gloo on the CPU; pass ``backend="gloo"`` where ranks share a card
    (NCCL refuses two ranks on one device). ``init_method`` is a
    ``tcp://host:port`` or ``file://`` rendezvous."""
    import datetime
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    torch.distributed.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(minutes=10))


def free_port() -> int:
    """A free TCP port on localhost, for a rendezvous of local ranks."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def shard_batch(batch: Dict, rank: int, world: int) -> Dict:
    """This rank's rows of a global batch (numpy arrays or tensors, nested
    dicts): the batch axis split into ``world`` equal parts."""
    def rows(v):
        if isinstance(v, dict):
            return {k: rows(x) for k, x in v.items()}
        n = v.shape[0] // world
        return v[rank * n:(rank + 1) * n]
    return {k: rows(v) for k, v in batch.items()}


def _rank_mean(tensors):
    """Each tensor's mean over the ranks, with one flattened all-reduce."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    flat = collectives.all_reduce_sum(flat) / torch.distributed \
        .get_world_size()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def loss_and_grads(model: CvaMVSNet, batch: Dict, loss_cfg: Dict):
    """One training forward and backward: the parameters' ``.grad`` hold
    the gradient of the total loss (under a process group: of the global
    batch's, the ranks' gradients averaged); returns (loss, losses,
    outputs), this rank's."""
    for p in model.parameters():
        p.grad = None
    out = forward_outputs(model, batch, train=True)
    loss, losses = compute_loss(out, batch, **loss_cfg)
    loss.backward()
    if collectives.in_group():
        params = list(model.parameters())
        grads = _rank_mean([torch.zeros_like(p) if p.grad is None
                            else p.grad for p in params])
        for p, g in zip(params, grads):
            p.grad = g
    return loss, losses, out


def _running_stats(model: nn.Module):
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def make_train_step(model: CvaMVSNet, config: Dict[str, Any],
                    with_metrics: bool = True,
                    with_outputs: bool = False) -> Callable:
    """``step(state, batch) -> (state, metrics)``: one optimizer step (and
    one LR-schedule step). ``metrics`` holds detached tensors on the
    batch's device (no host read): the loss terms, the stage errors under
    "stage/name" when ``with_metrics`` (under a process group both are
    the global batch's), and this rank's outputs under "_outputs" when
    ``with_outputs``."""
    loss_cfg = loss_config(config)
    sam_rho = float(config.get("TRAIN.SAM_RHO", 0.05))
    use_sam = bool(config.get("TRAIN.SAM", False))

    def train_step(state: TrainState, batch: Dict):
        params = [p for p in model.parameters()]
        stats = [b.clone() for b in _running_stats(model)] if use_sam else ()
        loss, losses, out = loss_and_grads(model, batch, loss_cfg)
        if use_sam:
            # SAM (adaptive=False): climb e_w = rho g / ||g||, take the
            # gradient there from the state's BatchNorm statistics, and
            # apply it at the base point. Loss and metrics stay the base
            # point's; the running statistics are the second pass's (as
            # the JAX step keeps them).
            from .utils import sam_perturb
            base = [p.detach().clone() for p in params]
            offsets = sam_perturb(params, [p.grad for p in params],
                                  rho=sam_rho)
            with torch.no_grad():
                for p, e in zip(params, offsets):
                    p.add_(e)
                for b, s in zip(_running_stats(model), stats):
                    b.copy_(s)
            loss_and_grads(model, batch, loss_cfg)
            with torch.no_grad():
                for p, b in zip(params, base):
                    p.copy_(b)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in losses.items()}}
        if with_metrics:
            with torch.no_grad():
                errs = eval_errors(out, batch)
            metrics.update({f"{s}/{k}": v for s, d in errs.items()
                            for k, v in d.items()})
        if collectives.in_group():
            metrics = dict(zip(metrics, _rank_mean(list(metrics.values()))))
        if with_outputs:
            metrics["_outputs"] = {s: {k: v.detach() for k, v in d.items()}
                                   for s, d in out.items()}
        return state, metrics
    return train_step


def make_eval_step(model: CvaMVSNet) -> Callable:
    """``step(batch) -> (outputs, per-sample errors)``, in eval mode."""
    def eval_step(batch: Dict):
        out = forward_outputs(model, batch, train=False)
        return out, eval_errors(out, batch, keep_batch=True)
    return eval_step


def current_lr(state: TrainState) -> float:
    return state.optimizer.param_groups[0]["lr"]
