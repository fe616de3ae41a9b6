"""Depth evaluation CLI: the reference eval.py on one card.

Port of ``tandem_tpu/cli/tandem_eval.py``: runs a checkpoint over the
Replica MVS split, accumulates the per-stage metrics, measures FPS, and
writes ``<ckpt>.pkl`` (the errors) and ``<ckpt>.txt`` in the reference's
table format (eval.py:114-141), plus a gt/pred depth PNG strip
(``<ckpt>.png``, 16-bit, depth / depth_max). It runs on the card unless
``--device cpu`` is given.

Usage:
  python -m tandem_tpu_torch.cli.tandem_eval --ckpt CKPT --data-root DIR \\
      [options]

CKPT may be a checkpoint directory of the port's trainer, a
``model_variables.pkl`` of the JAX package or a reference torch checkpoint.
The architecture is the ``model_config.json`` beside it (in a checkpoint
directory, or in the unit folder that holds the file), as the runtime
builds a unit's model; ``--depth-num`` and ``--[no-]view-aggregation``
override it, and without one they default to 48,32,8 with view
aggregation.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np

parser = argparse.ArgumentParser()
parser.add_argument("--ckpt", required=True)
parser.add_argument("--data-root", required=True)
parser.add_argument("--split", default="val")
parser.add_argument("--width", type=int, default=640)
parser.add_argument("--height", type=int, default=480)
parser.add_argument("--depth-min", type=float, default=0.01)
parser.add_argument("--depth-max", type=float, default=10.0)
parser.add_argument("--pose-ext", default="gt")
parser.add_argument("--tuples-ext", default="dso_optimization_windows")
parser.add_argument("--seed", type=int, default=1)
parser.add_argument("--view-aggregation",
                    action=argparse.BooleanOptionalAction, default=None,
                    help="the gated cascade (CVA-MVSNet) or, with "
                         "--no-view-aggregation, the variance one (CasMVSNet); "
                         "default: model_config.json's, else gated")
parser.add_argument("--depth-num", default=None,
                    help="per-stage depth planes; 48,4,4 = the deployed "
                         "abl04 architecture (default: model_config.json's, "
                         "else 48,32,8)")
parser.add_argument("--num-save-images", type=int, default=4)
parser.add_argument("--limit", type=int, default=0, help="eval first N only")
parser.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default) or the CPU")


def model_kwargs(args) -> dict:
    """The model's architecture for the checkpoint: its model_config.json
    (in the checkpoint directory, or beside the checkpoint file) where
    there is one, with the flags given on top; else the flags or their
    defaults."""
    from .golden import load_model_config

    ckpt = args.ckpt.rstrip("/")
    folder = ckpt if os.path.isdir(ckpt) else os.path.dirname(ckpt)
    kwargs = {"depth_num": (48, 32, 8), "view_aggregation": True}
    if os.path.exists(os.path.join(folder, "model_config.json")):
        kwargs = load_model_config(folder)
    if args.depth_num is not None:
        kwargs["depth_num"] = tuple(int(x) for x in
                                    str(args.depth_num).split(","))
    if args.view_aggregation is not None:
        kwargs["view_aggregation"] = args.view_aggregation
    return kwargs


def write_report(path_base: str, errors: dict, fps: float, args):
    error_names = ("abs_rel", "abs", "sq_rel", "rmse", "rmse_log",
                   "a1", "a2", "a3")
    ms = 1000.0 / fps
    with open(path_base + ".txt", "w") as fp:
        header = " " * 14 + ("{:>8s}   " * len(error_names)).format(*error_names)
        fmt = "{:>11s}:  " + "{:8.3f}   " * len(error_names)
        print(header, file=fp)
        for stage in ("stage1", "stage2", "stage3"):
            vals = tuple(float(errors[stage][n]) for n in error_names)
            print(fmt.format(stage.upper(), *vals), file=fp)
        print(f"Performance: {fps:5.2f} FPS,  {int(ms):5d} ms per image.",
              file=fp)
        print(f"Eigen et. al (delta <1.25, <1.25**2, <1.25**3): "
              f"{float(errors['stage3']['d1'])} "
              f"{float(errors['stage3']['d2'])} "
              f"{float(errors['stage3']['d3'])}", file=fp)
        name = path_base
        print("\nPaste last line into Google Sheets", file=fp)
        header2 = " " * (len(name) + 3) + ("{:>8s}   " * (len(error_names) + 5)
                                           ).format(*error_names, "width",
                                                    "height", "d_min",
                                                    "d_max", "seed")[:-3]
        print(header2, file=fp)
        fmt2 = ("{:>10s}   " + "{:8.4f}   " * len(error_names)
                + "{:8d}   {:8d}   {:8.4f}   {:8.4f}   {:8d}")
        vals = tuple(float(errors["stage3"][n]) for n in error_names)
        print(fmt2.format(name, *vals, args.width, args.height,
                          args.depth_min, args.depth_max, args.seed), file=fp)


def main(args) -> dict:
    """Evaluate; returns the mean errors {stage: {metric: float}}."""
    import torch

    from ..data.replica import MVSDataset, make_batches, write_png
    from ..models.factory import build_model
    from ..train.checkpoint import load_any
    from ..train.trainer import batch_to_device, make_eval_step

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("tandem_eval: no CUDA device; pass --device "
                               "cpu to evaluate on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    kwargs = model_kwargs(args)
    model = build_model(kwargs, torch.bfloat16
                        if args.dtype == "bfloat16" else torch.float32)
    model.load_state_dict(load_any(
        args.ckpt, view_aggregation=model.view_aggregation,
        architecture=model.architecture))
    model.to(device)
    eval_step = make_eval_step(model)

    ds = MVSDataset(args.data_root, args.split, pose_ext=args.pose_ext,
                    height=args.height, width=args.width,
                    tuples_ext=args.tuples_ext, ignore_pose_scale=True,
                    tuples_default_flag=False, tuples_default_frame_num=3,
                    tuples_default_frame_dist=20,
                    depth_min=args.depth_min, depth_max=args.depth_max)

    sums, count = None, 0
    images_out = []
    t0 = time.time()
    for i, batch in enumerate(make_batches(ds, 1, shuffle=False,
                                           drop_last=False)):
        if args.limit and i >= args.limit:
            break
        out, errs = eval_step(batch_to_device(batch, device))
        errs = {s: {k: float(v.mean()) for k, v in d.items()}
                for s, d in errs.items()}
        if sums is None:
            sums = errs
        else:
            sums = {s: {k: sums[s][k] + v for k, v in d.items()}
                    for s, d in errs.items()}
        count += 1
        if len(images_out) < args.num_save_images:
            gt = np.asarray(batch["depth"]["stage3"][0])
            pred = out["stage3"]["depth"][0].float().cpu().numpy()
            images_out.append(np.concatenate(
                [gt, pred], axis=0) / max(args.depth_max, 1e-6))
    elapsed = time.time() - t0
    fps = count / max(elapsed, 1e-9)

    errors = {s: {k: v / count for k, v in d.items()}
              for s, d in sums.items()}
    # (removesuffix, not rstrip: rstrip strips a CHAR SET and would eat
    # trailing 'c/k/p/t' letters of arbitrary checkpoint names)
    base = args.ckpt.rstrip("/").removesuffix(".ckpt")
    with open(base + ".pkl", "wb") as fp:
        pickle.dump(errors, fp)
    write_report(base, errors, fps, args)
    if images_out:
        strip = np.clip(np.concatenate(images_out, axis=1), 0, 1)
        write_png(base + ".png",
                  (strip * np.iinfo(np.uint16).max).astype(np.uint16))
    with open(base + ".txt") as fp:
        print(fp.read())
    return errors


if __name__ == "__main__":
    main(parser.parse_args())
