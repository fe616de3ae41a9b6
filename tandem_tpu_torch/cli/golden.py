"""The deployable MVSNet unit's architecture and its golden self-check.

Copies of ``load_model_config`` and ``verify_golden`` from
``tandem_tpu/cli/tandem_export.py``: a unit folder holds
``model_variables.pkl``, ``model_config.json`` (the model's constructor
arguments, with the ``"architecture"`` key where the unit is not a
CVA-MVSNet: ``models/factory.build_model`` builds it) and optionally
``sample_inputs.npz``, a golden pack of inputs and the reference model's
outputs. ``verify_golden`` replays the pack and
returns the worst mean absolute error over its outputs, the reference's
boot check (dr_mvsnet.cpp:505-521) at GOLDEN_TOL.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

GOLDEN_TOL = 1e-2  # dr_mvsnet_test threshold (dr_mvsnet.cpp:505-521)


def load_model_config(unit_dir: str) -> dict:
    """The unit's model configuration (``models/factory.build_model``'s
    argument: the constructor's kwargs, lists as tuples, and the
    architecture where it names one); a unit without model_config.json
    gets CVA-MVSNet's training defaults."""
    path = os.path.join(unit_dir, "model_config.json")
    if os.path.exists(path):
        with open(path) as f:
            cfg = json.load(f)
        return {k: (tuple(v) if isinstance(v, list) else v)
                for k, v in cfg.items()}
    return {"view_aggregation": True}


def verify_golden(pack_path: str, variables, device,
                  dtype=torch.float32) -> float:
    """Replay the golden pack through the unit's architecture in
    ``dtype`` on ``device``; return the worst mean absolute error over the
    12 outputs."""
    from ..models import convert
    from ..models.factory import build_model

    pack = np.load(pack_path)
    model = build_model(load_model_config(os.path.dirname(pack_path)),
                        dtype)
    model.load_state_dict(convert.flax_to_state_dict(
        variables, view_aggregation=model.view_aggregation,
        architecture=model.architecture))
    model = model.to(device).eval()
    image = pack["image"]
    if image.dtype == np.uint8:
        # Packs store quantized images; replay divides like the runtime.
        image = image.astype(np.float32) / 255.0

    def put(x):
        return torch.from_numpy(np.asarray(x)).to(device)
    with torch.no_grad():
        out = model(put(image), [put(pack[k]) for k in ("K1", "K2", "K3")],
                    put(pack["cam_to_world"]), put(pack["depth_min"]),
                    put(pack["depth_max"]),
                    torch.full((1,), float(pack["discard_percentage"])))
    worst = 0.0
    for stage in ("stage1", "stage2", "stage3"):
        for field in ("depth", "confidence", "depth_dense",
                      "confidence_dense"):
            got = getattr(getattr(out, stage), field).float().cpu().numpy()
            ref = pack[f"out.{stage}.{field}"]
            worst = max(worst, float(np.abs(ref - got).mean()))
    return worst
