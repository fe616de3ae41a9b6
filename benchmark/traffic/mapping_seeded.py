"""Keyframe-stream traffic (``mapping``'s) for a configuration that has no
trained unit in the repository: its weights are drawn from ``--seed``.

Set-up draws the weights on the device with flax's initializers
(``weights.init_params``) and writes them, with the configuration's
``model`` as ``model_config.json``, as a unit in a directory of its own
under TMPDIR: the layout ``tandem_dataset`` builds a runner from. The
configuration's copy names that directory as its ``unit``, and the
keyframe stream, its window and its correctness check are ``mapping``'s.

BatchNorm keeps its initial statistics (mean 0, variance 1) in the cell:
the activations shrink layer by layer and the softmax over the planes is
near uniform, so every depth lies within ~1e-5 of its stage's middle
plane, and fusion integrates a near-plane. ``write_unit`` can instead
set the statistics to those of the scene (``calibrate``, as the CPU
tests and ``chip_smoke.py`` do): the activations are then of unit scale
and the depth follows the cost volume, but seeded weights make that depth
noise over metres, and fusing a cycle of such keyframes fills the TSDF's
pool (262,144 blocks at 1152x864), after which the program fuses no new
surface and its volume parts from the unbounded plain integrator's.
Where the configuration has no view aggregation, the plain reference of
the sampled answers and of the ``mvsnet`` control is the variance cascade
(``reference/casmvsnet.py``) in place of ``common``'s gated one, for this
run only. The unit is removed once the check has run.
"""

from __future__ import annotations

import json
import math
import pickle
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..reference.casmvsnet import PlainCasMVSNet
from ..reference.cva_mvsnet import load_params
from . import common, mapping, scene, weights

# The keyframe windows whose forward sets the BatchNorm statistics,
# spread evenly over the stream's cycle.
CALIBRATION_WINDOWS = 3


def calibration_windows(config: dict, traffic: dict, device) -> list:
    """CALIBRATION_WINDOWS of the stream's keyframe windows (``mapping``'s),
    spread over its cycle, each as a call records its arguments."""
    path, every, V = traffic["path"], traffic["keyframe_every"], \
        config["views"]
    cycle = path["period"] // math.gcd(path["period"], every)
    cam = common.camera(config)
    offset = scene.texture_offset(traffic["decor_seed"])
    windows = []
    for k in range(CALIBRATION_WINDOWS):
        start = k * cycle // CALIBRATION_WINDOWS
        frames = [((start - V + 1 + i) % cycle) * every
                  % path["period"] for i in range(V)]
        bgrs, _, depths = scene.render_frames(frames, path, cam, offset,
                                              device)
        ref = depths[-2].cpu().numpy()
        idv = (1.0 / ref[ref > 0]).astype(np.float32)
        windows.append({
            "bgrs": list(bgrs), "K": cam.K, "dmin": 0.01,
            "dmax": 3.0 / max(mapping._idepth_quantile(idv, 0.2), 1e-3),
            "discard": traffic["discard_percentage"],
            "c2w": [scene.path_pose(f, path).astype(np.float32)
                    for f in frames]})
    return windows


def calibrate(params: dict, model: dict, windows: list, device) -> None:
    """Set each BatchNorm's statistics in ``params`` to those of its input
    in the plain float32 variance cascade's forwards of ``windows``, one
    window a forward (no larger than the check's own forwards): the mean
    and the biased variance over the positions, pooled over the windows.
    Within a forward each layer is normalised by its window's statistics,
    as training's forward normalises by the batch's."""
    ref = PlainCasMVSNet(params, model)
    eval_bn = ref._bn
    moments: dict = {}

    def kept(x, path: str):
        dims = [0] + list(range(2, x.dim()))
        mean, square = x.mean(dims), (x * x).mean(dims)
        params[f"batch_stats/{path}/mean"] = mean
        params[f"batch_stats/{path}/var"] = torch.clamp(
            square - mean * mean, min=0.0)
        m = moments.setdefault(path, [0.0, 0.0])
        m[0], m[1] = m[0] + mean, m[1] + square
        return eval_bn(x, path)
    ref._bn = kept
    with torch.no_grad():
        for w in windows:
            ref.cascade(*common.reference_inputs(w, device)[:5])
    for path, (mean, square) in moments.items():
        mean, square = mean / len(windows), square / len(windows)
        params[f"batch_stats/{path}/mean"] = mean
        params[f"batch_stats/{path}/var"] = torch.clamp(
            square - mean * mean, min=0.0)


def write_unit(unit: Path, model: dict, seed: int, device,
               windows: list = ()) -> None:
    """``model_variables.pkl`` (the weights drawn from ``seed``, with the
    BatchNorm statistics of ``windows`` where there are any, in the unit
    pickle's layout) and ``model_config.json`` (``model``) in ``unit``."""
    params = weights.init_params(model, seed, device)
    if windows:
        calibrate(params, model, windows, device)
    with open(unit / "model_variables.pkl", "wb") as f:
        pickle.dump(weights.nested_numpy(params), f)
    with open(unit / "model_config.json", "w") as f:
        json.dump(model, f, indent=1)


def variance_reference(root: Path, config: dict, device,
                       quant: str = "none") -> PlainCasMVSNet:
    """``common.reference_model``'s contract for the variance cascade."""
    return PlainCasMVSNet(
        load_params(str(common.unit_path(root, config,
                                         "model_variables.pkl")), device),
        config["model"], quant)


def run(ctx):
    unit = Path(tempfile.mkdtemp(prefix="seeded_unit_"))
    patches = common.Patches()
    try:
        write_unit(unit, ctx.config["model"], ctx.seed, ctx.device)
        ctx.config = dict(ctx.config, unit=str(unit))
        if not ctx.config["model"]["view_aggregation"]:
            patches.set(common, "reference_model", variance_reference)
        outcome = mapping.run(ctx)
    except BaseException:
        patches.undo()
        shutil.rmtree(unit, ignore_errors=True)
        raise
    check = outcome["check"]

    def checked():
        try:
            return check()
        finally:
            patches.undo()
            shutil.rmtree(unit, ignore_errors=True)
    outcome["check"] = checked
    return outcome
