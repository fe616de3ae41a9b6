"""models/convert.py: flax tree -> torch state_dict is the exact inverse of
the JAX package's torch -> flax converter, and ``state_dict_to_flax`` the
exact inverse of ``flax_to_state_dict``, on both shipped units."""

import json
import os

import numpy as np
import pytest

from tandem_tpu.models.torch_convert import convert_state_dict
from tandem_tpu_torch.models.convert import (flax_to_state_dict, load_variables,
                                             state_dict_to_flax)
from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNITS = ["tandem", "tandem_512x320"]


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{path}/{k}")


@pytest.mark.parametrize("name", UNITS)
def test_flax_to_torch_to_flax_is_identity(name):
    variables = load_variables(
        os.path.join(REPO, "exported", name, "model_variables.pkl"))
    sd = flax_to_state_dict(variables)
    back = convert_state_dict({k: v.numpy() for k, v in sd.items()},
                              view_aggregation=True)
    _assert_trees_equal(back, variables)


@pytest.mark.parametrize("name", UNITS)
def test_state_dict_loads_strictly(name):
    unit = os.path.join(REPO, "exported", name)
    with open(os.path.join(unit, "model_config.json")) as f:
        model = CvaMVSNet(**json.load(f))
    sd = flax_to_state_dict(load_variables(
        os.path.join(unit, "model_variables.pkl")))
    model.load_state_dict(sd, strict=True)
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("name", UNITS)
def test_state_dict_to_flax_is_the_inverse(name):
    """state_dict_to_flax(flax_to_state_dict(v)) == v on the trained
    abl04 variables: the same tree of float32 numpy arrays, bit for bit."""
    variables = load_variables(
        os.path.join(REPO, "exported", name, "model_variables.pkl"))
    back = state_dict_to_flax(flax_to_state_dict(variables))
    _assert_trees_equal(back, variables)
    for leaf in _leaves(back):
        assert isinstance(leaf, np.ndarray) and leaf.dtype == np.float32


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)
