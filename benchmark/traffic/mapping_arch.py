"""Keyframe-stream traffic (``mapping``'s) for a configuration whose model is
another architecture than CVA-MVSNet, with weights drawn from ``--seed``:
the configuration's ``model`` names it (``"architecture"``), and the next
architecture needs only its plain reference
(``reference/<architecture>.py``: ``PLAIN``, the reference's class, and
``param_shapes``), its operation count (``harness/<architecture>_work.py``:
``mvsnet_ops``) and a configuration.

Set-up draws the weights with ``weights.init_params``'s initialisers over
the reference's ``param_shapes``, BatchNorm at its initial statistics, and
writes them with the configuration's ``model`` as a unit under TMPDIR
(``write_unit``, in ``mapping_seeded``'s layout). For the run it builds
the map path through the program's factory (``build_map_path``, in
``common``'s place), makes the architecture's reference the sampled
answers' and the ``mvsnet`` control's (``common.reference_model``),
counts the forward's operations from the architecture's own count
(``work.mvsnet_ops``) and adds ``wta_flip_share`` to the answers' gaps
(``common.mvs_gaps``). The keyframe stream, its window and its check are
``mapping``'s. Before the check the run reports the fused volume's blocks,
the pool and its drops on standard error. The unit is removed once the
check has run.
"""

from __future__ import annotations

import importlib
import json
import pickle
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Optional

import torch

from ..harness import work
from ..reference.cva_mvsnet import load_params
from . import common, mapping, weights

# A winner-take-all depth is one of its stage's planes: a pixel whose depth
# parts from the reference's by more than this share of the reference's
# largest depth took another plane (a stage-3 plane interval is ~5e-3 of
# it; rounding moves a plane by a few float32 ulps of it).
FLIP_GAP = 1e-4
# The backend the run's map path was built with (``build_map_path``).
_BUILT: dict = {}


def reference_module(config: dict):
    return importlib.import_module(
        f"benchmark.reference.{config['model']['architecture']}")


def calibrate(ref, params: dict, windows: list, device) -> None:
    """``mapping_seeded.calibrate`` for the reference ``ref`` (built on
    ``params``), with each variance taken about its mean (two passes): a
    layer whose input has a large mean and a small spread (TransMVSNet's
    view-weight net on the similarity) loses E[x^2] - E[x]^2 to float32
    cancellation. The statistics pooled over the windows are the mean of
    the means and the mean of (variance + (its mean - the pooled
    mean)^2)."""
    eval_bn = ref._bn
    moments: dict = {}

    def kept(x, path: str):
        dims = [0] + list(range(2, x.dim()))
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mean = x.mean(dims)
        var = ((x - mean.reshape(shape)) ** 2).mean(dims)
        params[f"batch_stats/{path}/mean"] = mean
        params[f"batch_stats/{path}/var"] = var
        moments.setdefault(path, []).append((mean, var))
        return eval_bn(x, path)
    ref._bn = kept
    with torch.no_grad():
        for w in windows:
            ref.cascade(*common.reference_inputs(w, device)[:5])
    for path, seen in moments.items():
        mean = sum(m for m, _ in seen) / len(seen)
        params[f"batch_stats/{path}/mean"] = mean
        params[f"batch_stats/{path}/var"] = sum(
            v + (m - mean) ** 2 for m, v in seen) / len(seen)


def write_unit(unit: Path, model: dict, seed: int, device,
               windows: list = ()) -> None:
    """``mapping_seeded.write_unit`` for the architecture: its parameters
    (the reference's ``param_shapes``) drawn from ``seed`` and, with
    ``windows``, BatchNorm statistics from its reference (``calibrate``).
    """
    ref = reference_module({"model": model})
    saved = weights.param_shapes
    weights.param_shapes = ref.param_shapes
    try:
        params = weights.init_params(model, seed, device)
    finally:
        weights.param_shapes = saved
    if windows:
        calibrate(ref.PLAIN(params, model), params, windows, device)
    with open(unit / "model_variables.pkl", "wb") as f:
        pickle.dump(weights.nested_numpy(params), f)
    with open(unit / "model_config.json", "w") as f:
        json.dump(model, f, indent=1)


def reference_model(root: Path, config: dict, device, quant: str = "none"):
    """``common.reference_model``'s contract for the architecture."""
    return reference_module(config).PLAIN(
        load_params(str(common.unit_path(root, config,
                                         "model_variables.pkl")), device),
        config["model"], quant)


def build_map_path(root: Path, config: dict, device,
                   patches: common.Patches, timer=None,
                   control: Optional[dict] = None):
    """``common.build_map_path`` with the model from the program's factory
    (``models/factory.build_model``) for the configuration's
    architecture."""
    from tandem_tpu_torch.mapping.tsdf import TsdfConfig
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.factory import build_model
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner

    cam = common.camera(config)
    model = build_model(config["model"], common.DTYPES[config["dtype"]])
    runner = MvsnetRunner(
        model, load_variables(str(common.unit_path(root, config,
                                                   "model_variables.pkl"))),
        cam.height, cam.width, view_num=config["views"], device=device)
    if control and "mvsnet" in control:
        runner._forward = common.ReferenceForward(
            common.reference_model(root, config, device, control["mvsnet"]))
    backend = TandemBackend(runner, TsdfConfig(**config["tsdf"]), cam.K,
                            cam.height, cam.width, mesh_extraction_freq=0,
                            timer=timer)
    _BUILT["backend"] = backend
    return runner, backend, common.FusedScans(patches)


def mvs_gaps(depth, conf, ref_depth, ref_conf) -> dict:
    """``common.mvs_gaps`` and ``wta_flip_share``: the share of the pixels
    both keep whose depth took another plane than the reference's."""
    gaps = _MVS_GAPS(depth, conf, ref_depth, ref_conf)
    d, rd = depth.float().reshape(-1), ref_depth.float().reshape(-1)
    both = (d > 0) & (rd > 0)
    flipped = both & ((d - rd).abs() > FLIP_GAP * rd.max())
    gaps["wta_flip_share"] = float(flipped.sum()) / max(int(both.sum()), 1)
    return gaps


_MVS_GAPS = common.mvs_gaps


def _report_volume(backend) -> None:
    vol, cfg = backend.volume, backend.cfg
    print(f"diag volume fused_blocks {vol.n_allocated} pool_size "
          f"{cfg.pool_size} pool_max {cfg.pool_max} dropped "
          f"{vol.n_dropped}", file=sys.stderr)


def run(ctx):
    # the program's factory first: a program without it fails here, at once
    importlib.import_module("tandem_tpu_torch.models.factory")
    model = ctx.config["model"]
    ops = importlib.import_module(
        f"benchmark.harness.{model['architecture']}_work").mvsnet_ops
    unit = Path(tempfile.mkdtemp(prefix="seeded_unit_"))
    patches = common.Patches()
    try:
        write_unit(unit, model, ctx.seed, ctx.device)
        ctx.config = dict(ctx.config, unit=str(unit))
        patches.set(common, "build_map_path", build_map_path)
        patches.set(common, "reference_model", reference_model)
        patches.set(common, "mvs_gaps", mvs_gaps)
        patches.set(work, "mvsnet_ops", ops)
        outcome = mapping.run(ctx)
    except BaseException:
        patches.undo()
        shutil.rmtree(unit, ignore_errors=True)
        raise
    release, check = outcome["release"], outcome["check"]

    def released():
        _report_volume(_BUILT.pop("backend"))
        release()

    def checked():
        try:
            return check()
        finally:
            patches.undo()
            shutil.rmtree(unit, ignore_errors=True)
    outcome["release"], outcome["check"] = released, checked
    return outcome
