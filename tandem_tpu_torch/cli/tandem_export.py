"""Export CLI: the reference's export_model.py on the card.

Port of ``tandem_tpu/cli/tandem_export.py``. Writes a deployable unit
into ``--out-dir``:

- ``sample_inputs.npz``: the golden pack, the inputs (the seed-0 synthetic
  window, or the first "val" tuple of ``--data-root``), the discard
  percentage and the model's 12 outputs (``out.<stage>.<field>``);
- ``model_variables.pkl``: the weights as the JAX package's variables
  (plain dicts of numpy arrays, ``models.convert.state_dict_to_flax``) and
  ``model_config.json``, the ``CvaMVSNet`` constructor arguments;
- ``depth.png`` / ``confidence.png``: stage 3, 16-bit;
- ``model.pt2``: ``torch.export`` of ``models.cva_mvsnet.Stage3Forward``
  (the JAX export's eight inputs and four outputs, the weights inside),
  saved with ``torch.export.save``, and ``model.pt2.json``, the device and
  dtype it was exported for. The hand kernels are the custom ops
  ``tandem::warp_sample`` and ``tandem::edge_filter``, nodes of the graph:
  the program launches them on the card and runs their plain versions on
  the CPU. ``pipeline.mvsnet_runner.ExportedRunner`` serves it, and a unit
  folder with ``model.pt2`` and no weights boots ``tandem_dataset``.

Both replays of the pack must stay under GOLDEN_TOL (dr_mvsnet.cpp:
505-521): through the saved program (``verify_exported``) and through the
eager model (``cli/golden.verify_golden``). It runs on the card unless
``--device cpu`` is given.

Usage:
  python -m tandem_tpu_torch.cli.tandem_export --ckpt CKPT \\
      --out-dir OUT [--data-root DIR] [--width 640 --height 480] \\
      [--view-num 7] [--depth-num 48,4,4] [--device cpu]

CKPT may be a ``model_variables.pkl``, a checkpoint directory of the port's
trainer or a reference torch checkpoint (``train/checkpoint.load_any``).
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np

from ..pipeline.full_system import resolve_device
from .golden import GOLDEN_TOL, verify_golden

parser = argparse.ArgumentParser()
parser.add_argument("--ckpt", required=True)
parser.add_argument("--data-root", default=None,
                    help="Replica root; if absent, a synthetic window is used")
parser.add_argument("--out-dir", required=True)
parser.add_argument("--width", type=int, default=640)
parser.add_argument("--height", type=int, default=480)
parser.add_argument("--view-num", type=int, default=7)
parser.add_argument("--discard-percentage", type=float, default=10.0)
parser.add_argument("--view-aggregation", action="store_true", default=True)
parser.add_argument("--depth-num", default="48,32,8",
                    help="per-stage depth planes; the SHIPPED reference "
                         "model is 48,4,4 (abl04)")
parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default) or the CPU; the program serves "
                         "on the device it was exported on")

PROGRAM = "model.pt2"
PROGRAM_INFO = "model.pt2.json"
INPUTS = ("image", "K1", "K2", "K3", "cam_to_world", "depth_min",
          "depth_max")
STAGE3 = ("stage3.depth", "stage3.confidence", "stage3.depth_dense",
          "stage3.confidence_dense")


def _model_kwargs_from_args(args) -> dict:
    return {"depth_num": tuple(int(x) for x in
                               str(args.depth_num).split(",")),
            "view_aggregation": args.view_aggregation}


def build_inputs(args) -> dict:
    """The golden window as numpy: the first "val" tuple of
    ``args.data_root``, or the seed-0 synthetic window of the JAX CLI."""
    if args.data_root:
        from ..data.replica import MVSDataset, collate
        ds = MVSDataset(args.data_root, "val", height=args.height,
                        width=args.width)
        batch = collate([ds[0]])
        return {
            "image": batch["image"].astype(np.float32),
            "K1": batch["intrinsics"]["stage1"]["K"][:, 0],
            "K2": batch["intrinsics"]["stage2"]["K"][:, 0],
            "K3": batch["intrinsics"]["stage3"]["K"][:, 0],
            "cam_to_world": batch["cam_to_world"],
            "depth_min": batch["depth_min"],
            "depth_max": batch["depth_max"],
        }
    rng = np.random.RandomState(0)
    H, W, V = args.height, args.width, args.view_num
    K3 = np.array([[0.6 * W, 0, (W - 1) / 2], [0, 0.6 * W, (H - 1) / 2],
                   [0, 0, 1]], np.float32)
    c2w = np.broadcast_to(np.eye(4, dtype=np.float32), (1, V, 4, 4)).copy()
    for v in range(V):
        c2w[0, v, 0, 3] = 0.05 * v
    return {
        "image": rng.rand(1, V, 3, H, W).astype(np.float32),
        "K1": (K3 * np.array([[0.25], [0.25], [1]], np.float32))[None],
        "K2": (K3 * np.array([[0.5], [0.5], [1]], np.float32))[None],
        "K3": K3[None],
        "cam_to_world": c2w,
        "depth_min": np.full((1,), 0.5, np.float32),
        "depth_max": np.full((1,), 6.0, np.float32),
    }


def _load_model(variables, model_kwargs: dict, device):
    from ..models import convert
    from ..models.cva_mvsnet import CvaMVSNet
    model = CvaMVSNet(**model_kwargs)
    model.load_state_dict(convert.flax_to_state_dict(
        variables, view_aggregation=model.view_aggregation))
    return model.to(device).eval()


def program_inputs(inputs: dict, discard_percentage: float, device) -> tuple:
    """The program's eight arguments: the seven inputs on ``device`` (a
    uint8 image divided by 255 as the runtime divides) and the discard
    percentage as a (1,) float32 CPU tensor (the edge filter reads it
    without a device sync)."""
    import torch
    image = inputs["image"]
    if image.dtype == np.uint8:
        image = image.astype(np.float32) / 255.0
    put = [torch.from_numpy(np.ascontiguousarray(image)).to(device)]
    put += [torch.from_numpy(np.asarray(inputs[k])).to(device)
            for k in INPUTS[1:]]
    return (*put, torch.full((1,), float(discard_percentage)))


def run_model(variables, inputs, args):
    """The eager model on ``args.device``, on the pack's inputs:
    {"<stage>.<field>": numpy} of the 12 outputs, edge-filtered at
    ``args.discard_percentage``."""
    import torch

    dev = resolve_device(args.device)
    model = _load_model(variables, _model_kwargs_from_args(args), dev)
    image, K1, K2, K3, c2w, dmin, dmax, disc = program_inputs(
        inputs, args.discard_percentage, dev)
    out = model(image, (K1, K2, K3), c2w, dmin, dmax,
                depth_filter_discard_percentage=disc)
    outputs = {}
    for stage in ("stage1", "stage2", "stage3"):
        s = getattr(out, stage)
        for field in ("depth", "confidence", "depth_dense",
                      "confidence_dense"):
            outputs[f"{stage}.{field}"] = \
                getattr(s, field).to(torch.float32).cpu().numpy()
    return outputs


def export_program(variables, inputs, args, path: str):
    """``torch.export`` the stage-3 forward on ``args.device`` with
    ``inputs`` (``build_inputs``') as the example and save it to ``path``,
    with the device and dtype beside it (``path`` + ".json"). Returns the
    ExportedProgram."""
    import torch

    from ..models.cva_mvsnet import Stage3Forward

    dev = resolve_device(args.device)
    model = _load_model(variables, _model_kwargs_from_args(args), dev)
    model.requires_grad_(False)     # a deployable: no output wants a grad
    example = program_inputs(inputs, args.discard_percentage, dev)
    program = torch.export.export(Stage3Forward(model), example)
    program.example_inputs = None   # not kept: 26 MB of image at 640x480
    torch.export.save(program, path)
    with open(path + ".json", "w") as f:
        json.dump({"device": dev.type, "dtype": "float32",
                   "image_shape": list(example[0].shape),
                   "torch": torch.__version__}, f, indent=1)
    return program


def load_program(unit_dir: str, device=None):
    """The unit's saved program, for ``device`` (by default the one it was
    exported for): its custom ops registered first (importing their
    modules), the process's precision flags set as the model sets them,
    and another device than the one it was exported for refused.

    :return: (ExportedProgram, the torch.device it serves on)"""
    import torch

    from ..models.cva_mvsnet import pin_f32_precision
    from ..ops import bilinear_sample, deconv3d, edge_kth  # noqa: F401

    with open(os.path.join(unit_dir, PROGRAM_INFO)) as f:
        info = json.load(f)
    dev = torch.device(info["device"] if device is None else device)
    if dev.type != info["device"]:
        raise ValueError(f"{unit_dir}/{PROGRAM} was exported for "
                         f"{info['device']}, asked to serve on {dev}: "
                         f"export it again with --device {dev.type}")
    pin_f32_precision()
    return torch.export.load(os.path.join(unit_dir, PROGRAM)), dev


def replay_exported(module, pack, device) -> tuple:
    """The program (``ExportedProgram.module()``) on the golden pack's
    inputs: its four stage-3 outputs."""
    import torch
    with torch.no_grad():
        return module(*program_inputs(
            pack, float(pack["discard_percentage"]), device))


def verify_exported(unit_dir: str, device=None, module=None) -> float:
    """Replay the unit's golden pack through its program (loaded, unless
    the caller passes its ``ExportedProgram.module()``); return the worst
    mean absolute error over the four stage-3 outputs (the counterpart of
    the JAX package's ``verify_stablehlo``)."""
    if module is None:
        program, device = load_program(unit_dir, device)
        module = program.module()
    pack = np.load(os.path.join(unit_dir, "sample_inputs.npz"))
    outs = replay_exported(module, pack, device)
    return max(float(np.abs(pack["out." + k]
                            - v.float().cpu().numpy()).mean())
               for k, v in zip(STAGE3, outs))


def main(args) -> dict:
    """Export the unit; return the two replays' errors and the export's
    seconds."""
    from ..data.replica import write_png
    from ..models.convert import state_dict_to_flax
    from ..train.checkpoint import load_any

    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    variables = state_dict_to_flax(
        load_any(args.ckpt, view_aggregation=args.view_aggregation),
        view_aggregation=args.view_aggregation)

    inputs = build_inputs(args)
    outputs = run_model(variables, inputs, args)

    pack = dict(inputs)
    pack["discard_percentage"] = np.float32(args.discard_percentage)
    for k, v in outputs.items():
        pack["out." + k] = v
    pack_path = os.path.join(args.out_dir, "sample_inputs.npz")
    np.savez_compressed(pack_path, **pack)

    with open(os.path.join(args.out_dir, "model_variables.pkl"), "wb") as f:
        pickle.dump(variables, f)
    # Self-describing unit: the runtime builds the model from this.
    with open(os.path.join(args.out_dir, "model_config.json"), "w") as f:
        json.dump(_model_kwargs_from_args(args), f, indent=1)

    # Human-inspectable depth/confidence PNGs (export_model.py:185-190)
    d = outputs["stage3.depth"][0]
    c = outputs["stage3.confidence"][0]
    write_png(os.path.join(args.out_dir, "depth.png"),
              (np.clip(d / max(d.max(), 1e-6), 0, 1) * 65535
               ).astype(np.uint16))
    write_png(os.path.join(args.out_dir, "confidence.png"),
              (np.clip(c, 0, 1) * 65535).astype(np.uint16))

    t0 = time.perf_counter()
    export_program(variables, inputs, args,
                   os.path.join(args.out_dir, PROGRAM))
    export_s = time.perf_counter() - t0
    print(f"exported {PROGRAM} for {dev.type} in {export_s:.1f} s "
          f"({os.path.getsize(os.path.join(args.out_dir, PROGRAM))} bytes)")
    serr = verify_exported(args.out_dir, dev)
    print(f"{PROGRAM} golden replay mean-abs-error: {serr:.2e} "
          f"({'OK' if serr < GOLDEN_TOL else 'FAIL'})")
    assert serr < GOLDEN_TOL

    err = verify_golden(pack_path, variables, dev)
    print(f"golden self-check mean-abs-error: {err:.2e} "
          f"({'OK' if err < GOLDEN_TOL else 'FAIL'})")
    assert err < GOLDEN_TOL
    return {"exported_mae": serr, "golden_mae": err, "export_s": export_s}


if __name__ == "__main__":
    main(parser.parse_args())
