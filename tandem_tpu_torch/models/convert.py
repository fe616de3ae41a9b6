"""tandem_tpu flax variables -> the port's torch state_dict.

The exact inverse of ``tandem_tpu/models/torch_convert.py``
``convert_state_dict``: the JAX package's parameter tree (plain numpy dicts,
as pickled in ``exported/*/model_variables.pkl``) becomes a state_dict
under the reference model's key names, which the port's modules use.
Layout conversions (inverse of the forward converter):

- Conv2d  (kh, kw, I, O)        -> (O, I, kh, kw)
- Conv3d  (kd, kh, kw, I, O)    -> (O, I, kd, kh, kw)
- ConvTranspose3d: the flax kernel is stored spatially flipped in
  (kd, kh, kw, I, O); un-flip, then -> (I, O, kd, kh, kw)
- BatchNorm scale/bias -> weight/bias; batch_stats mean/var ->
  running_mean/running_var (plus a zero num_batches_tracked).

The 640x480 unit ships with BN folded into the convs (bn.weight = 1,
mean = 0); it converts like any other unit.
"""

from __future__ import annotations

import pickle
from typing import Dict

import numpy as np
import torch

STAGES = ("stage1", "stage2", "stage3")

_FEATURE_CONVS = [
    ("conv0.0", "conv0_0"), ("conv0.1", "conv0_1"),
    ("conv1.0", "conv1_0"), ("conv1.1", "conv1_1"), ("conv1.2", "conv1_2"),
    ("conv2.0", "conv2_0"), ("conv2.1", "conv2_1"), ("conv2.2", "conv2_2"),
]
_COSTREG_CONVS = ["conv0", "conv1", "conv2", "conv3", "conv4", "conv5", "conv6"]
_COSTREG_DECONVS = ["conv7", "conv9", "conv11"]


def load_variables(path: str) -> dict:
    """Read a ``model_variables.pkl`` (a plain pickle of numpy dicts written
    by this repository's export; unpickle only such trusted files)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def _conv2d(w):
    return np.transpose(w, (3, 2, 0, 1))


def _conv3d(w):
    return np.transpose(w, (4, 3, 0, 1, 2))


def _deconv3d(w):
    return np.transpose(w[::-1, ::-1, ::-1], (3, 4, 0, 1, 2))


def flax_to_state_dict(variables: dict, view_aggregation: bool = True
                       ) -> Dict[str, torch.Tensor]:
    """:param variables: {'params': ..., 'batch_stats': ...} numpy tree.
    :return: state_dict of CPU float32 tensors for ``CvaMVSNet``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.tensor(np.array(value, np.float32, order="C"))

    def bn(dst: str, p: dict, s: dict):
        put(f"{dst}.weight", p["scale"])
        put(f"{dst}.bias", p["bias"])
        put(f"{dst}.running_mean", s["mean"])
        put(f"{dst}.running_var", s["var"])
        sd[f"{dst}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    def conv_bn(dst: str, p: dict, s: dict, conv_fn):
        put(f"{dst}.conv.weight", conv_fn(p["conv"]["kernel"]))
        bn(f"{dst}.bn", p["bn"], s["bn"])

    fp, fs = params["feature_net"], stats["feature_net"]
    for dst, src in _FEATURE_CONVS:
        conv_bn(f"feature_net.{dst}", fp[src], fs[src], _conv2d)
    for s in STAGES:
        put(f"feature_net.out.{s}.weight", _conv2d(fp[f"out_{s}"]["kernel"]))
    for s in ("stage2", "stage3"):
        put(f"feature_net.skip.{s}.weight", _conv2d(fp[f"skip_{s}"]["kernel"]))
        put(f"feature_net.skip.{s}.bias", fp[f"skip_{s}"]["bias"])

    for s in STAGES:
        dst = f"cost_regularization_net.{s}"
        cp, cs = params[f"cost_reg_{s}"], stats[f"cost_reg_{s}"]
        for c in _COSTREG_CONVS:
            conv_bn(f"{dst}.{c}", cp[c], cs[c], _conv3d)
        for c in _COSTREG_DECONVS:
            put(f"{dst}.{c}.conv.weight", _deconv3d(cp[c]["kernel"]))
            bn(f"{dst}.{c}.bn", cp[c]["bn"], cs[c]["bn"])
        put(f"{dst}.prob.weight", _conv3d(cp["prob"]["kernel"]))

    if view_aggregation:
        # Sequential(0 Conv3d, 1 BN, 2 ReLU, 3 Conv3d, 4 BN, 5 ReLU)
        for s in STAGES:
            dst = f"volume_gates.{s}"
            gp, gs = params[f"volume_gate_{s}"], stats[f"volume_gate_{s}"]
            put(f"{dst}.0.weight", _conv3d(gp["gate0"]["kernel"]))
            put(f"{dst}.0.bias", gp["gate0"]["bias"])
            bn(f"{dst}.1", gp["bn0"], gs["bn0"])
            put(f"{dst}.3.weight", _conv3d(gp["gate1"]["kernel"]))
            put(f"{dst}.3.bias", gp["gate1"]["bias"])
            bn(f"{dst}.4", gp["bn1"], gs["bn1"])
    return sd
