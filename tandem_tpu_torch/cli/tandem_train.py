"""Training CLI: the reference train.py, on one card or data-parallel.

Port of ``tandem_tpu/cli/tandem_train.py``: CVA-MVSNet trained on the
Replica MVS split ``train`` of DATA.ROOT_DIR, the linear-decay LR schedule
with warmup (tandem.py:56-96), optional augmentation (AUG.*), a checkpoint
after every epoch (``<OUT_DIR>/ckpt/step_N``) and TensorBoard logging with
a sample-scaled x axis. It runs on the card unless ``TRAIN.DEVICE cpu`` is
given. Data parallelism (``train/trainer.py``): ``TRAIN.DEVICE mesh``
spawns one rank a visible card (NCCL); ``multihost`` joins the ranks named
by the environment (``config.rendezvous``; each process runs this CLI, on
the CPU with gloo under ``TANDEM_PLATFORM=cpu``). The global batch is
TRAIN.BATCH_SIZE x the ranks, as in the JAX CLI; every rank prints the
``step N loss X`` lines (the global batch's loss), rank 0 alone writes the
checkpoints and TensorBoard, and all ranks share OUT_DIR.

Usage:
  python -m tandem_tpu_torch.cli.tandem_train OUT_DIR --config CFG.yaml \\
      [--pretrained CKPT] [KEY VALUE]...

The KEY VALUE overrides may stand before or after the options (the
arguments are parsed intermixed: Python 3.12.3's argparse otherwise gives
the overrides nothing after ``--config``). CKPT may be a checkpoint
directory of this trainer (a resume: model, optimizer, schedule and
step), a ``model_variables.pkl`` of the JAX package or a reference torch
checkpoint (weights only).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

parser = argparse.ArgumentParser()
parser.add_argument("out_dir")
parser.add_argument("--config", default=None)
parser.add_argument("--pretrained", default=None)
parser.add_argument("overrides", nargs="*", default=[])


def main(args) -> dict:
    """Train; returns {"steps", "losses" (one a step), "seconds" (host
    clock of each step, synchronized on the card), "checkpoints"} (rank
    0's under mesh)."""
    from .. import config as cfg

    config = _config(args)
    mode = config["TRAIN.DEVICE"]
    if mode == "mesh":
        import torch
        cfg.train_device(config)            # raises without a card
        return _spawn_mesh(args, torch.cuda.device_count())
    if mode == "multihost":
        return train(args, config, *cfg.rendezvous())
    return train(args, config)


def _config(args) -> dict:
    from .. import config as cfg
    config = cfg.default()
    if args.config:
        cfg.merge_from_file(config, args.config)
    if args.overrides:
        cfg.merge_from_list(config, list(args.overrides))
    return config


def _spawn_mesh(args, world: int) -> dict:
    """One rank a card, spawned, over a localhost rendezvous; rank 0's
    result. A failed rank raises here."""
    import torch.multiprocessing as mp

    from ..train.trainer import free_port
    init = f"tcp://localhost:{free_port()}"
    results = mp.get_context("spawn").SimpleQueue()
    ranks = mp.start_processes(_mesh_rank, args=(args, world, init, results),
                               nprocs=world, join=False,
                               start_method="spawn")
    result = None
    while not ranks.join(timeout=1.0):
        if result is None and not results.empty():
            result = results.get()
    return result if result is not None else results.get()


def _mesh_rank(rank: int, args, world: int, init: str, results) -> None:
    res = train(args, _config(args), init, world, rank)
    if rank == 0:
        results.put(res)


def train(args, config: dict, init_method: str = None, world: int = 1,
          rank: int = 0) -> dict:
    """The training loop of one process: rank ``rank`` of ``world`` ranks
    joined at ``init_method`` (mesh, multihost), or alone."""
    import torch

    from .. import config as cfg
    from ..train.trainer import init_process_group

    device = cfg.train_device(config, rank)
    os.makedirs(args.out_dir, exist_ok=True)
    existing = [f for f in os.listdir(args.out_dir) if not f.startswith(".")]
    if existing:
        # DDP-safety parity: out_dir must be empty (utils.py:229-238).
        # Every rank looks before the group is joined, so before rank 0
        # writes anything.
        raise FileExistsError(f"Output dir {args.out_dir} is not empty.")
    if init_method is not None:
        init_process_group(device, init_method, world, rank)
    try:
        return _loop(args, config, device, world, rank)
    finally:
        if init_method is not None:
            torch.distributed.destroy_process_group()


def _loop(args, config: dict, device, world: int, rank: int) -> dict:
    import torch

    from ..data.augment import augment_batch
    from ..data.replica import MVSDataset, make_batches
    from ..train.checkpoint import load_any, save_checkpoint
    from ..train.tb_logger import TBLogger
    from ..train.trainer import (batch_to_device, create_train_state,
                                 current_lr, make_train_step, shard_batch)

    np.random.seed(config["TRAIN.SEED"])
    ds = MVSDataset(config["DATA.ROOT_DIR"], "train",
                    pose_ext=config["DATA.POSE_EXT"],
                    height=config["DATA.IMG_HEIGHT"],
                    width=config["DATA.IMG_WIDTH"],
                    tuples_ext=config["DATA.TUPLES_EXT"],
                    ignore_pose_scale=config["DATA.IGNORE_POSE_SCALE"],
                    tuples_default_flag=config["DATA.TUPLES_DEFAULT_FLAG"],
                    tuples_default_frame_num=config["DATA.TUPLES_DEFAULT_FRAME_NUM"],
                    tuples_default_frame_dist=config["DATA.TUPLES_DEFAULT_FRAME_DIST"],
                    depth_min=config["DATA.DEPTH_MIN"],
                    depth_max=config["DATA.DEPTH_MAX"])

    batch_size = config["TRAIN.BATCH_SIZE"] * world
    steps_per_epoch = len(ds) // batch_size
    total_steps = config["TRAIN.EPOCHS"] * steps_per_epoch

    # Every rank draws the same initialization and the same batches.
    model, state = create_train_state(
        config, torch.Generator().manual_seed(config["TRAIN.SEED"]),
        total_steps, world_size=world, device=device)
    if args.pretrained:
        loaded = load_any(args.pretrained, state,
                          view_aggregation=config["MODEL.VIEW_AGGREGATION"])
        if isinstance(loaded, dict):       # weights only: a warm start
            model.load_state_dict(loaded)
        else:
            state = loaded

    summaries = tuple(config.get("IO.SUMMARIES") or ())
    step_fn = make_train_step(model, config, with_outputs=bool(summaries))
    logger = TBLogger(args.out_dir, samples_per_step=batch_size,
                      enabled=rank == 0)
    aug_gen = torch.Generator().manual_seed(config["TRAIN.SEED"] + 1)

    ckpt_dir = os.path.join(args.out_dir, "ckpt")
    global_step = 0
    max_steps = int(config.get("TRAIN.MAX_STEPS", 0) or 0)
    losses, seconds, checkpoints = [], [], []
    done = False
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    for epoch in range(config["TRAIN.EPOCHS"]):
        if done:
            break
        for batch in make_batches(ds, batch_size,
                                  shuffle=config["TRAIN.SHUFFLE"],
                                  drop_last=config["TRAIN.DROP_LAST"],
                                  seed=config["TRAIN.SEED"] + epoch,
                                  num_workers=config["TRAIN.NUM_WORKERS"]):
            t0 = time.perf_counter()
            dev_batch = batch_to_device(batch, device)
            if config["AUG.ANY"]:
                dev_batch = augment_batch(
                    aug_gen, dev_batch,
                    same_on_views=config["AUG.SAME_ON_VIEWS"],
                    color_jitter_params=config["AUG.COLOR_JITTER"],
                    motion_blur_params=config["AUG.MOTION_BLUR"])
            dev_batch = shard_batch(dev_batch, rank, world)
            lr = current_lr(state)
            state, metrics = step_fn(state, dev_batch)
            losses.append(metrics["loss"])
            sync()
            seconds.append(time.perf_counter() - t0)

            if global_step % config["IO.LOG_INTERVAL"] == 0:
                outputs = metrics.pop("_outputs", None)
                if outputs is not None:
                    logger.add_summaries("train", dev_batch, outputs,
                                         global_step, summaries=summaries)
                loss = float(metrics["loss"])
                print(f"epoch {epoch} step {global_step} loss {loss:.4f} "
                      f"lr {lr:.3e} ({seconds[-1] * 1e3:.1f} ms)",
                      flush=True)
                scalars = {k: v for k, v in metrics.items() if "loss" in k}
                errors = {}
                for k, v in metrics.items():
                    if "/" in k:
                        s, name = k.split("/", 1)
                        errors.setdefault(s, {})[name] = v
                logger.add_scalars("train", scalars, errors, global_step)
                logger.add_lr("train", lr, global_step)
            global_step += 1
            if max_steps and global_step >= max_steps:
                done = True
                break

        if rank == 0:
            checkpoints.append(save_checkpoint(ckpt_dir, state))
        logger.flush()
    logger.close()
    return {"steps": global_step,
            "losses": [float(v) for v in losses],
            "seconds": seconds, "checkpoints": checkpoints}


if __name__ == "__main__":
    main(parser.parse_intermixed_args())
