"""tandem_tpu flax variables <-> the port's torch state_dict.

The exact inverse of ``tandem_tpu/models/torch_convert.py``
``convert_state_dict``: the JAX package's parameter tree (plain numpy dicts,
as pickled in ``exported/*/model_variables.pkl``) becomes a state_dict
under the reference model's key names, which the port's modules use;
``state_dict_to_flax`` goes back. Layout conversions (inverse of the
forward converter):

- Conv2d  (kh, kw, I, O)        -> (O, I, kh, kw)
- Conv3d  (kd, kh, kw, I, O)    -> (O, I, kd, kh, kw)
- ConvTranspose3d: the flax kernel is stored spatially flipped in
  (kd, kh, kw, I, O); un-flip, then -> (I, O, kd, kh, kw)
- BatchNorm scale/bias -> weight/bias; batch_stats mean/var ->
  running_mean/running_var (plus a zero num_batches_tracked).

The 640x480 unit ships with BN folded into the convs (bn.weight = 1,
mean = 0); it converts like any other unit.

TransMVSNet (``architecture="transmvsnet"``) shares the FeatureNet and the
U-Nets' paths (its U-Nets take one input channel) and adds ``arf_<stage>``
(``offset``, ``mask`` and ``conv``), ``fmt`` (``self_<i>`` and
``cross_<i>``: Dense ``q``, ``k``, ``v``, ``merge``, ``mlp0``, ``mlp1``,
LayerNorm ``norm1``, ``norm2``), ``pathway`` (``reduce_<stage>``,
``smooth_<stage>``) and ``view_weight`` (``conv0``, ``conv1`` with
BatchNorm, ``conv2`` with bias). Dense (I, O) -> Linear (O, I); LayerNorm
scale/bias -> weight/bias.
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


# Layouts: flax -> torch, and back.
_LAYOUTS = {
    # Conv2d (kh, kw, I, O) -> (O, I, kh, kw)
    "conv2d": (lambda w: np.transpose(w, (3, 2, 0, 1)),
               lambda w: np.transpose(w, (2, 3, 1, 0))),
    # Conv3d (kd, kh, kw, I, O) -> (O, I, kd, kh, kw)
    "conv3d": (lambda w: np.transpose(w, (4, 3, 0, 1, 2)),
               lambda w: np.transpose(w, (2, 3, 4, 1, 0))),
    # ConvTranspose3d: un-flip, then (kd, kh, kw, I, O) -> (I, O, kd, kh, kw)
    "deconv3d": (lambda w: np.transpose(w[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)),
                 lambda w: np.transpose(w, (2, 3, 4, 0, 1))[::-1, ::-1, ::-1]),
    "vector": (lambda w: w, lambda w: w),
    # Dense (I, O) -> Linear (O, I)
    "dense": (lambda w: np.transpose(w), lambda w: np.transpose(w)),
}
FMT_LINEAR = ("q", "k", "v", "merge", "mlp0", "mlp1")


def _entries(view_aggregation: bool, architecture: str = "cva_mvsnet",
             fmt_layers: int = 0):
    """(state_dict key, flax path, layout) of every converted tensor; the
    path starts with "params" or "batch_stats"."""
    if architecture not in ("cva_mvsnet", "transmvsnet"):
        raise ValueError(f"architecture {architecture!r}: 'cva_mvsnet' or "
                         "'transmvsnet'")
    out = []

    def bn(dst: str, p: tuple, s: tuple):
        out.extend([(f"{dst}.weight", ("params", *p, "scale"), "vector"),
                    (f"{dst}.bias", ("params", *p, "bias"), "vector"),
                    (f"{dst}.running_mean", ("batch_stats", *s, "mean"),
                     "vector"),
                    (f"{dst}.running_var", ("batch_stats", *s, "var"),
                     "vector")])

    def conv_bn(dst: str, p: tuple, layout: str):
        out.append((f"{dst}.conv.weight", ("params", *p, "conv", "kernel"),
                    layout))
        bn(f"{dst}.bn", (*p, "bn"), (*p, "bn"))

    for dst, src in _FEATURE_CONVS:
        conv_bn(f"feature_net.{dst}", ("feature_net", src), "conv2d")
    for s in STAGES:
        out.append((f"feature_net.out.{s}.weight",
                    ("params", "feature_net", f"out_{s}", "kernel"),
                    "conv2d"))
    for s in ("stage2", "stage3"):
        out.append((f"feature_net.skip.{s}.weight",
                    ("params", "feature_net", f"skip_{s}", "kernel"),
                    "conv2d"))
        out.append((f"feature_net.skip.{s}.bias",
                    ("params", "feature_net", f"skip_{s}", "bias"),
                    "vector"))

    for s in STAGES:
        dst, src = f"cost_regularization_net.{s}", f"cost_reg_{s}"
        for c in _COSTREG_CONVS:
            conv_bn(f"{dst}.{c}", (src, c), "conv3d")
        for c in _COSTREG_DECONVS:
            out.append((f"{dst}.{c}.conv.weight",
                        ("params", src, c, "kernel"), "deconv3d"))
            bn(f"{dst}.{c}.bn", (src, c, "bn"), (src, c, "bn"))
        out.append((f"{dst}.prob.weight", ("params", src, "prob", "kernel"),
                    "conv3d"))

    if architecture == "transmvsnet":
        _transmvsnet_entries(out, conv_bn, fmt_layers)
    elif view_aggregation:
        # Sequential(0 Conv3d, 1 BN, 2 ReLU, 3 Conv3d, 4 BN, 5 ReLU)
        for s in STAGES:
            dst, src = f"volume_gates.{s}", f"volume_gate_{s}"
            for i, (conv, norm) in enumerate((("gate0", "bn0"),
                                              ("gate1", "bn1"))):
                out.append((f"{dst}.{3 * i}.weight",
                            ("params", src, conv, "kernel"), "conv3d"))
                out.append((f"{dst}.{3 * i}.bias",
                            ("params", src, conv, "bias"), "vector"))
                bn(f"{dst}.{3 * i + 1}", (src, norm), (src, norm))
    return out


def _transmvsnet_entries(out: list, conv_bn, fmt_layers: int):
    """TransMVSNet's own tensors (the module's docstring), with
    ``fmt_layers`` encoder layers."""
    for s in STAGES:
        for part in ("offset", "mask", "conv"):
            out.append((f"arf.{s}.{part}.weight",
                        ("params", f"arf_{s}", part, "kernel"), "conv2d"))
        for part in ("offset", "mask"):
            out.append((f"arf.{s}.{part}.bias",
                        ("params", f"arf_{s}", part, "bias"), "vector"))
    for i in range(fmt_layers):
        name = f"{('self', 'cross')[i % 2]}_{i // 2}"
        for lin in FMT_LINEAR:
            out.append((f"fmt.layers.{i}.{lin}.weight",
                        ("params", "fmt", name, lin, "kernel"), "dense"))
        for norm in ("norm1", "norm2"):
            out.append((f"fmt.layers.{i}.{norm}.weight",
                        ("params", "fmt", name, norm, "scale"), "vector"))
            out.append((f"fmt.layers.{i}.{norm}.bias",
                        ("params", "fmt", name, norm, "bias"), "vector"))
    for s in ("stage2", "stage3"):
        for part in ("reduce", "smooth"):
            out.append((f"pathway.{part}.{s}.weight",
                        ("params", "pathway", f"{part}_{s}", "kernel"),
                        "conv2d"))
    for c in ("conv0", "conv1"):
        conv_bn(f"view_weight.{c}", ("view_weight", c), "conv3d")
    out.append(("view_weight.conv2.weight",
                ("params", "view_weight", "conv2", "kernel"), "conv3d"))
    out.append(("view_weight.conv2.bias",
                ("params", "view_weight", "conv2", "bias"), "vector"))


def flax_to_state_dict(variables: dict, view_aggregation: bool = True,
                       architecture: str = "cva_mvsnet"
                       ) -> Dict[str, torch.Tensor]:
    """:param variables: {'params': ..., 'batch_stats': ...} numpy tree.
    :param architecture: the model's (``CvaMVSNet.architecture`` or
        ``TransMVSNet.architecture``); TransMVSNet has no view aggregation
    :return: state_dict of CPU float32 tensors for the model."""
    sd: Dict[str, torch.Tensor] = {}
    layers = (len(variables["params"]["fmt"])
              if architecture == "transmvsnet" else 0)
    for key, path, layout in _entries(view_aggregation, architecture,
                                      layers):
        leaf = variables
        for name in path:
            leaf = leaf[name]
        sd[key] = torch.tensor(np.array(_LAYOUTS[layout][0](leaf),
                                        np.float32, order="C"))
        if key.endswith(".running_var"):
            sd[key[:-len("running_var")] + "num_batches_tracked"] = \
                torch.zeros((), dtype=torch.int64)
    return sd


def state_dict_to_flax(state_dict, view_aggregation: bool = True) -> dict:
    """The inverse of ``flax_to_state_dict``: a ``CvaMVSNet`` state_dict
    (e.g. ``train/checkpoint.load_any``'s) as the JAX package's variables,
    {'params': ..., 'batch_stats': ...} of plain dicts of float32 numpy
    arrays, the tree ``model_variables.pkl`` holds. The
    ``num_batches_tracked`` counters have no counterpart and are dropped.
    """
    tree: dict = {}
    for key, path, layout in _entries(view_aggregation):
        node = tree
        for name in path[:-1]:
            node = node.setdefault(name, {})
        value = state_dict[key].detach().to("cpu", torch.float32).numpy()
        node[path[-1]] = np.ascontiguousarray(_LAYOUTS[layout][1](value))
    return tree
