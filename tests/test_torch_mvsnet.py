"""CVA-MVSNet parity: the PyTorch port against the JAX package, module by
module and as a whole, plus the trained golden packs.

Small scale: 64x96, V=3, depth planes (8, 4, 4) — the smallest width the
JAX U-Net takes (every cascade stage must halve three times evenly: W/4
divisible by 8). Weights are random, drawn with numpy into the JAX
package's parameter tree (shapes from ``jax.eval_shape`` of its init) with
non-trivial BatchNorm statistics, and converted by models/convert.py.
Tolerance f32 atol 1e-4: the two frameworks sum the convolutions in
different orders (the measured gap is ~1e-6).
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tandem_tpu.models.cost_reg import CostRegNet as JCostRegNet
from tandem_tpu.models.cost_reg import VolumeGate as JVolumeGate
from tandem_tpu.models.cva_mvsnet import CvaMVSNet as JCvaMVSNet
from tandem_tpu.models.feature_net import FeatureNet as JFeatureNet
from tandem_tpu.models.ranges import (adaptive_depth_range as j_adaptive,
                                      uniform_depth_range as j_uniform)
from tandem_tpu.ops.warp import plane_sweep_warp as j_warp
from tandem_tpu_torch.models.convert import flax_to_state_dict, load_variables
from tandem_tpu_torch.models.cost_reg import VolumeGate
from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
from tandem_tpu_torch.models.ranges import (adaptive_depth_range,
                                            uniform_depth_range)
from tandem_tpu_torch.ops.warp import plane_sweep_warp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4
GOLDEN_TOL = 1e-2  # dr_mvsnet_test threshold (tests/test_parity_trained.py)
H, W, V = 64, 96, 3
DEPTH_NUM = (8, 4, 4)


def random_variables(model, height, width, views, seed):
    """A random parameter tree for the JAX ``model`` drawn with numpy:
    fan-in scaled normal kernels, small biases, and BatchNorm with
    non-trivial scale/bias/mean/var. The tree's shapes come from
    ``jax.eval_shape`` of the model's init (tracing only, no compile)."""
    img = jnp.zeros((1, views, 3, height, width), jnp.float32)
    Ks = tuple(jnp.broadcast_to(jnp.eye(3) * s, (1, 3, 3))
               for s in (100.0, 200.0, 400.0))
    c2w = jnp.broadcast_to(jnp.eye(4), (1, views, 4, 4))
    shapes = jax.eval_shape(
        lambda k: model.init(k, img, Ks, c2w, jnp.full((1,), 0.5),
                             jnp.full((1,), 10.0), train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        n = leaf.shape
        if name == "kernel":
            std = 1.0 / np.sqrt(max(np.prod(n[:-1]), 1))
            return (std * rng.randn(*n)).astype(np.float32)
        if name == "scale":
            return (1 + 0.2 * rng.randn(*n)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*n)).astype(np.float32)
        return (0.1 * rng.randn(*n)).astype(np.float32)   # bias, mean
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _build(view_aggregation: bool):
    jm = JCvaMVSNet(depth_num=DEPTH_NUM, view_aggregation=view_aggregation)
    variables = random_variables(jm, H, W, V, seed=3)
    tm = CvaMVSNet(depth_num=DEPTH_NUM,
                   view_aggregation=view_aggregation).eval()
    tm.load_state_dict(flax_to_state_dict(variables, view_aggregation))
    return jm, variables, tm


@pytest.fixture(scope="module")
def models():
    return _build(True)


def _sub(variables, name):
    return {"params": variables["params"][name],
            "batch_stats": variables["batch_stats"].get(name, {})}


def _inputs(rng):
    image = rng.rand(1, V, 3, H, W).astype(np.float32)
    K = np.array([[70.0, 0, (W - 1) / 2], [0, 70.0, (H - 1) / 2], [0, 0, 1]],
                 np.float32)
    Ks = []
    for s in (0.25, 0.5, 1.0):
        k = K.copy()
        k[:2] *= s
        Ks.append(k[None])
    c2w = np.tile(np.eye(4, dtype=np.float32), (1, V, 1, 1))
    for v in range(V):
        a = 0.03 * (v - 1)
        c2w[0, v, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                             [-np.sin(a), 0, np.cos(a)]]
        c2w[0, v, :3, 3] = [0.12 * (v - 1), 0.02 * v, 0.03 * v]
    return (image, Ks, c2w, np.full((1,), 0.5, np.float32),
            np.full((1,), 6.0, np.float32))


def test_feature_net(models):
    _, variables, tm = models
    x = np.random.RandomState(0).rand(2, H, W, 3).astype(np.float32)
    ref = JFeatureNet().apply(_sub(variables, "feature_net"), jnp.asarray(x))
    with torch.no_grad():
        out = tm.feature_net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for s in ("stage1", "stage2", "stage3"):
        np.testing.assert_allclose(out[s].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref[s]), atol=ATOL)


@pytest.mark.parametrize("stage,four", [("stage1", False), ("stage2", True)])
def test_cost_reg_net(models, stage, four):
    _, variables, tm = models
    D, C, s = (8, 32, 4) if stage == "stage1" else (4, 16, 2)
    x = np.random.RandomState(1).rand(1, D, H // s, W // s, C).astype(
        np.float32)
    ref = JCostRegNet(has_four_depths=four).apply(
        _sub(variables, f"cost_reg_{stage}"), jnp.asarray(x))[..., 0]
    with torch.no_grad():
        out = tm.cost_regularization_net[stage](
            torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def live_gate(variables, tm, dtype=torch.float32):
    """The stage-1 gate's JAX variables and a port VolumeGate with the same
    weights, except that both flip the sign of the second 1x1 conv: in
    this weight draw it is negative, which makes the gate identically zero
    after its ReLUs and any comparison vacuous."""
    gv = _sub(variables, "volume_gate_stage1")
    gv = {"batch_stats": gv["batch_stats"], "params": {
        **gv["params"], "gate1": {**gv["params"]["gate1"],
                                  "kernel": -gv["params"]["gate1"]["kernel"]}}}
    gate = VolumeGate(32, dtype).eval()
    gate.load_state_dict(tm.volume_gates["stage1"].state_dict())
    with torch.no_grad():
        gate[3].weight.neg_()
    return gv, gate


def test_volume_gate(models):
    _, variables, tm = models
    gate_vars, gate = live_gate(variables, tm)
    x = np.random.RandomState(2).rand(1, 8, 16, 24, 32).astype(np.float32)
    ref = JVolumeGate().apply(gate_vars, jnp.asarray(x))
    with torch.no_grad():
        out = gate(torch.from_numpy(x))
    assert (np.asarray(ref) > 0).mean() > 0.2
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_plane_sweep_warp():
    rng = np.random.RandomState(4)
    image, Ks, c2w, _, _ = _inputs(rng)
    feat = rng.rand(1, H // 2, W // 2, 16).astype(np.float32)
    depth = (0.5 + 5 * rng.rand(1, 4, H // 2, W // 2)).astype(np.float32)
    # Views 1 and 2 as source; one camera sits behind part of the sweep.
    c2w_back = c2w[:, 2].copy()
    c2w_back[0, 2, 3] = 3.0
    for src_c2w in (c2w[:, 1], c2w[:, 2], c2w_back):
        kw = dict(src_K=Ks[1], src_cam_to_world=src_c2w, ref_K=Ks[1],
                  ref_cam_to_world=c2w[:, 0])
        w_j, m_j = j_warp(jnp.asarray(feat), jnp.asarray(depth),
                          **{k: jnp.asarray(v) for k, v in kw.items()})
        w_t, m_t = plane_sweep_warp(
            torch.from_numpy(feat), torch.from_numpy(depth),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        assert w_t.shape == (1, 4, H // 2, W // 2, 16)
        np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=ATOL)
        assert (m_t.numpy() != np.asarray(m_j)).mean() < 1e-3


@pytest.mark.parametrize("inverse", [False, True])
def test_ranges(inverse):
    rng = np.random.RandomState(5)
    dmin = np.array([0.5, 1.0], np.float32)
    dmax = np.array([6.0, 4.0], np.float32)
    d_j, iv_j = j_uniform(depth_min=jnp.asarray(dmin),
                          depth_max=jnp.asarray(dmax), depth_num=48,
                          height=8, width=12)
    d_t, iv_t = uniform_depth_range(depth_min=torch.from_numpy(dmin),
                                    depth_max=torch.from_numpy(dmax),
                                    depth_num=48, height=8, width=12)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6)
    np.testing.assert_allclose(iv_t.numpy(), np.asarray(iv_j), atol=1e-7)
    prev = (0.5 + 3 * rng.rand(2, 16, 24)).astype(np.float32)
    a_j = j_adaptive(depth=jnp.asarray(prev), interval=0.5 * iv_j,
                     depth_num=8, inverse_depth=inverse)
    a_t = adaptive_depth_range(depth=torch.from_numpy(prev),
                               interval=0.5 * iv_t, depth_num=8,
                               inverse_depth=inverse)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-5)


@pytest.mark.parametrize("view_aggregation", [True, False])
def test_cva_mvsnet(models, view_aggregation):
    """The whole cascade with the edge filter; view aggregation on (the
    deployed abl04 model) and off (the variance cost volume)."""
    jm, variables, tm = models if view_aggregation else _build(False)
    image, Ks, c2w, dmin, dmax = _inputs(np.random.RandomState(6))
    disc = np.full((1,), 10.0, np.float32)
    ref = jax.jit(lambda v, *a: jm.apply(
        v, *a, depth_filter_discard_percentage=jnp.asarray(disc)))(
        variables, jnp.asarray(image), tuple(jnp.asarray(k) for k in Ks),
        jnp.asarray(c2w), jnp.asarray(dmin), jnp.asarray(dmax))
    out = tm(torch.from_numpy(image), [torch.from_numpy(k) for k in Ks],
             torch.from_numpy(c2w), torch.from_numpy(dmin),
             torch.from_numpy(dmax), torch.from_numpy(disc))
    for s in ("stage1", "stage2", "stage3"):
        for f in ("depth", "confidence", "depth_dense", "confidence_dense"):
            a = getattr(getattr(out, s), f).numpy()
            b = np.asarray(getattr(getattr(ref, s), f))
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=ATOL, err_msg=f"{s}.{f}")


def _golden_mae(name):
    unit = os.path.join(REPO, "exported", name)
    with open(os.path.join(unit, "model_config.json")) as f:
        model = CvaMVSNet(**json.load(f)).eval()
    model.load_state_dict(flax_to_state_dict(load_variables(
        os.path.join(unit, "model_variables.pkl"))))
    pack = np.load(os.path.join(unit, "sample_inputs.npz"))
    out = model(torch.from_numpy(pack["image"].astype(np.float32) / 255.0),
                [torch.from_numpy(pack[k]) for k in ("K1", "K2", "K3")],
                torch.from_numpy(pack["cam_to_world"]),
                torch.from_numpy(pack["depth_min"]),
                torch.from_numpy(pack["depth_max"]),
                torch.full((1,), float(pack["discard_percentage"])))
    worst = 0.0
    for s in ("stage1", "stage2", "stage3"):
        for f in ("depth", "confidence", "depth_dense", "confidence_dense"):
            got = getattr(getattr(out, s), f).numpy()
            worst = max(worst, float(np.abs(got - pack[f"out.{s}.{f}"])
                                     .mean()))
    return worst


def test_trained_golden_512x320():
    """Worst MAE over all 12 outputs below the reference's boot-check bar
    (measured ~5e-5 on the CPU)."""
    err = _golden_mae("tandem_512x320")
    assert err < GOLDEN_TOL, f"trained-weight parity broken: MAE={err:.2e}"


@pytest.mark.slow
def test_trained_golden_640x480():
    err = _golden_mae("tandem")
    assert err < GOLDEN_TOL, f"trained-weight parity broken: MAE={err:.2e}"
