"""Training traffic: the trainer's step (``train/trainer.py``) in a closed
loop, fed by the program's loader (``data/replica.py``: ``MVSDataset`` and
``make_batches`` with its worker threads and the C PNG decoder), as
``tandem_train`` runs an epoch: each step a batch to the device, the step,
and a synchronize.

The data is a Replica-format scene that set-up renders from the scene's
periodic path and writes under TMPDIR (``replica_files.py``): ``frames``
frames, every ``frame_every``-th of the path, and 7-view tuples every
``tuple_stride`` frames. The initial weights are made on the card from the
seed (``weights.py``) and loaded into the program's model; the loader
shuffles with the seed.

Set-up takes the first ``reference_steps`` steps through the same step and
loader, keeping their losses, the first gradient as Adam holds it (its
first moment over 1 - beta1) and the parameters before and after; then
the window runs on from that state. Correctness, once the window has
closed and the program is freed: the plain reference (``reference/
train_step.py``) takes the same steps from the same weights on the same
batches, built from the scene's arrays; the first step's loss, and by
the worst leaf the first gradient and the parameters' change after the
steps, are compared.
"""

from __future__ import annotations

import functools
import itertools
import math
import shutil
import tempfile
import time

import numpy as np
import torch

from ..harness import work
from ..harness.tracing import DeviceTrace, Trace
from ..reference import train_step as ref_train
from . import common, replica_files, scene, weights


def flax_names(convert, view_aggregation: bool) -> dict:
    """The unit pickle's path of each program parameter, from the
    program's own conversion table (the one that loads the seed's weights
    into it: a wrong entry fails the loss comparison)."""
    return {key: "/".join(path) for key, path, _ in
            convert._entries(view_aggregation) if path[0] == "params"}


def _epochs(make_batches, ds, conf):
    """The loader's batches, epoch after epoch, as the CLI draws them."""
    for epoch in itertools.count():
        yield from make_batches(ds, conf["TRAIN.BATCH_SIZE"],
                                shuffle=conf["TRAIN.SHUFFLE"],
                                drop_last=conf["TRAIN.DROP_LAST"],
                                seed=conf["TRAIN.SEED"] + epoch,
                                num_workers=conf["TRAIN.NUM_WORKERS"])


def _first_tuples(n_tuples: int, conf: dict, steps: int) -> list:
    """The tuple indices of the first ``steps`` batches of epoch 0: the
    loader's documented order (numpy's shuffle of 0..n-1 from the seed,
    in batches)."""
    order = np.arange(n_tuples)
    if conf["TRAIN.SHUFFLE"]:
        np.random.RandomState(conf["TRAIN.SEED"]).shuffle(order)
    B = conf["TRAIN.BATCH_SIZE"]
    return [order[i * B:(i + 1) * B].tolist() for i in range(steps)]


def run(ctx):
    from tandem_tpu_torch import config as pconfig
    from tandem_tpu_torch.data.replica import MVSDataset, make_batches
    from tandem_tpu_torch.models import convert
    from tandem_tpu_torch.train.trainer import (batch_to_device,
                                                create_train_state,
                                                make_train_step)

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    cam = common.camera(cfg)
    path = tr["path"]
    V = cfg["views"]
    idx = [(i * tr["frame_every"]) % path["period"]
           for i in range(tr["frames"])]
    bgrs, _, depths = scene.render_frames(
        idx, path, cam, scene.texture_offset(tr["decor_seed"]), dev)
    rgbs = np.ascontiguousarray(bgrs[..., ::-1])
    depth_m = depths.cpu().numpy()
    del depths
    poses = [scene.path_pose(i, path).astype(np.float32) for i in idx]
    tuples = [list(range(s, s + V))
              for s in range(0, tr["frames"] - V + 1, tr["tuple_stride"])]
    root = tempfile.mkdtemp(prefix="tandem_bench_train_")
    replica_files.write_scene(root, cam.K, cam.width, cam.height, rgbs,
                              depth_m, poses, tuples)

    conf = pconfig.default()
    conf.update({k: tuple(v) if isinstance(v, list) else v
                 for k, v in cfg["trainer"].items()})
    conf["DATA.ROOT_DIR"] = root
    conf["TRAIN.SEED"] = ctx.seed % (2 ** 31)
    B = conf["TRAIN.BATCH_SIZE"]
    ds = MVSDataset(root, "train", pose_ext=conf["DATA.POSE_EXT"],
                    height=cam.height, width=cam.width,
                    tuples_ext=conf["DATA.TUPLES_EXT"],
                    ignore_pose_scale=conf["DATA.IGNORE_POSE_SCALE"],
                    depth_min=conf["DATA.DEPTH_MIN"],
                    depth_max=conf["DATA.DEPTH_MAX"])
    total_steps = conf["TRAIN.EPOCHS"] * (len(ds) // B)
    # One sample read on this thread first: the loader's workers would
    # otherwise race to build the program's host library.
    ds[0]
    model, state = create_train_state(
        conf, torch.Generator().manual_seed(conf["TRAIN.SEED"]),
        total_steps, device=dev)
    params0 = weights.init_params(cfg["model"], ctx.seed, dev)
    model.load_state_dict(convert.flax_to_state_dict(
        weights.nested_numpy(params0),
        view_aggregation=cfg["model"]["view_aggregation"]))
    step_fn = make_train_step(model, conf)
    batches = _epochs(make_batches, ds, conf)
    named = dict(model.named_parameters())

    def step():
        batch = next(batches)
        nonlocal state
        state, metrics = step_fn(state, batch_to_device(batch, dev))
        torch.cuda.synchronize()
        return batch, metrics

    n_ref = tr["reference_steps"]
    before = {n: p.detach().clone() for n, p in named.items()}
    losses, first_grad, fed = [], None, []
    for t in range(n_ref):
        batch, metrics = step()
        fed.append(batch["image"][:, 0].copy())
        losses.append(metrics["loss"].detach().clone())
        if t == 0:
            b1 = state.optimizer.param_groups[0]["betas"][0]
            # an optimizer that took no step holds no moment: nothing
            first_grad = {n: state.optimizer.state[p].get(
                "exp_avg", torch.zeros_like(p)) / (1 - b1)
                for n, p in named.items()}
    change = {n: p.detach() - before[n] for n, p in named.items()}
    del before

    host_spans, waits, grad_calls = [], [], []
    patches = common.Patches()
    if ctx.trace:
        _record_grad_calls(patches, grad_calls)
    setup_s = time.time() - ctx.t_start
    dtrace = DeviceTrace() if ctx.trace else None
    if dtrace:
        dtrace.__enter__()
    steps = 0
    t0 = time.perf_counter()
    while True:
        ta, na = time.perf_counter(), time.time_ns()
        batch = next(batches)
        tb, nb = time.perf_counter(), time.time_ns()
        waits.append((tb - ta) * 1e3)
        state, _ = step_fn(state, batch_to_device(batch, dev))
        torch.cuda.synchronize()
        steps += 1
        t1 = time.perf_counter()
        if ctx.trace:
            host_spans += [("loader", na, nb), ("step", nb, time.time_ns())]
        if t1 - t0 >= ctx.seconds:
            break
    window_s = t1 - t0
    if dtrace:
        dtrace.__exit__(None, None, None)
    patches.undo()

    outcome = {"attempted": steps, "failed": 0,
               "e2e": {"train_samples_s": steps * B / window_s,
                       "setup_s": setup_s},
               "window_s": window_s}
    if ctx.trace:
        fwd = B * work.mvsnet_ops(cfg["model"], cam.height, cam.width, V)
        outcome["trace"] = Trace(
            window_s=window_s, kernels=dtrace.kernels(),
            spans={"loader_wait": waits}, counters={"steps": steps},
            calls={"warp_sample_grad": [
                work.sample_grad_work(*shape, int(read))
                for shape, read in grad_calls]},
            facts={"t0_ns": dtrace.t0_ns, "t1_ns": dtrace.t1_ns,
                   "dtype": cfg["dtype"], "step_ops": 3 * fwd})
        outcome["host_spans"] = host_spans

    def release():
        nonlocal state
        batches.close()
        state = None
        model.cpu()
        shutil.rmtree(root, ignore_errors=True)

    names = flax_names(convert, cfg["model"]["view_aggregation"])

    def check():
        return train_check(ctx, cfg, conf, rgbs, depth_m, poses, tuples,
                           params0, losses, first_grad, change, fed,
                           total_steps, names)

    outcome["release"], outcome["check"] = release, check
    return outcome


def reference_readings(cfg, conf, rgbs, depth_m, poses, tuples, params0,
                       total_steps, steps, device, quant="none"):
    """The plain reference's steps: (losses, first gradient, change, the
    batches' reference-view images)."""
    K = common.camera(cfg).K
    units = replica_files.depth_units(depth_m)
    batches = [ref_train.make_batch(
        rgbs, units, replica_files.DEPTH_SCALE, poses,
        [tuples[i] for i in ids], K, conf["DATA.DEPTH_MIN"],
        conf["DATA.DEPTH_MAX"], device)
        for ids in _first_tuples(len(tuples), conf, steps)]
    B = conf["TRAIN.BATCH_SIZE"]
    lrs = [ref_train.lr_at(t, conf["TRAIN.LR"], total_steps,
                           conf["TRAIN.LR_SCHEDULE_FINAL_FRACTION"],
                           int(500 * (16 / B))) for t in range(steps)]
    losses, first, change = ref_train.train_steps(params0, cfg["model"],
                                                  batches, lrs, quant)
    views = [b["image"][:, 0] for b in batches]
    return losses, first, change, views


def _record_grad_calls(patches, grad_calls):
    """Each backward plane sweep's shape (B, D, H, W, C, the incoming
    gradient's bytes an element) and the count of its samples that land
    in the image, kept on the card until the window has closed."""
    from tandem_tpu_torch.ops import bilinear_sample
    grad = bilinear_sample.warp_sample_grad

    # wraps: the program counts its launches on the function it looks up
    @functools.wraps(grad)
    def recorded(grad_out, ref_to_src, depth, min_depth_thres=0.001):
        B, D, H, W, C = grad_out.shape
        grad_calls.append(((B, D, H, W, C, grad_out.element_size()),
                           work.grad_read_samples(ref_to_src, depth, H, W,
                                                  min_depth_thres)))
        return grad(grad_out, ref_to_src, depth, min_depth_thres)
    patches.set(bilinear_sample, "warp_sample_grad", recorded)


def train_check(ctx, cfg, conf, rgbs, depth_m, poses, tuples, params0,
                losses, first_grad, change, fed, total_steps, names):
    """The program's first steps against the reference's; with the control,
    the reference in the control's precision takes the program's place."""
    dev = ctx.device
    args = (cfg, conf, rgbs, depth_m, poses, tuples, params0, total_steps,
            len(losses), dev)
    r_losses, r_first, r_change, views = reference_readings(*args)
    if "train" in ctx.control:
        losses, p_first, p_change, fed = reference_readings(
            *args, quant=ctx.control["train"])
        fed = [v.cpu().numpy() for v in fed]
    else:
        p_first = {names[n]: g for n, g in first_grad.items()}
        p_change = {names[n]: d for n, d in change.items()}
    # the reference's batches are the loader's: the same reference views
    same = all(np.array_equal(f, v.cpu().numpy()) for f, v in
               zip(fed, views))
    # The first step's loss: the later steps' losses swing from seed to
    # seed with the backward's atomics order, amplified through stage 1's
    # softmax (PERF.md, section 2).
    got = {"batches_differ": 0.0 if same else 1.0,
           "loss_gap": abs(float(losses[0]) - r_losses[0])
           / abs(r_losses[0]),
           "grad_gap": ref_train.norm_gap(p_first, r_first, r_first),
           "update_gap": ref_train.norm_gap(p_change, r_change, r_first)}
    return [(k, got.get(k, math.nan), lim) for k, lim in ctx.limits.items()]
