"""A unit's model from its ``model_config.json``: the architecture named by
its ``"architecture"`` key (``"cva_mvsnet"`` where the key is missing, the
units TANDEM deploys), built with the rest of the configuration as its
constructor's arguments."""

from __future__ import annotations

import torch

from .cva_mvsnet import CvaMVSNet
from .transmvsnet import TransMVSNet

ARCHITECTURES = {"cva_mvsnet": CvaMVSNet, "transmvsnet": TransMVSNet}


def build_model(config: dict, dtype=torch.float32):
    """:param config: ``cli/golden.load_model_config``'s dict (or a
        configuration's ``model``)
    :return: the architecture's module in ``dtype``, its weights not yet
        loaded"""
    kwargs = dict(config)
    name = kwargs.pop("architecture", "cva_mvsnet")
    if name not in ARCHITECTURES:
        raise ValueError(f"architecture {name!r}: one of "
                         f"{sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name](**kwargs, dtype=dtype)
