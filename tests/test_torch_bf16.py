"""The bfloat16 map path (the JAX package's deployed dtype): the PyTorch
port in bf16 against the JAX modules with ``dtype=jnp.bfloat16``, module by
module and as a whole, plus the trained golden in bf16.

Same scale, weights and inputs as tests/test_torch_mvsnet.py (64x96, V=3,
depth planes (8, 4, 4), random numpy weights converted by
models/convert.py). bf16 parity is a tolerance, not bit equality: XLA on
the CPU lets bf16 elementwise chains skip intermediate roundings, eager
torch rounds after every op, and the convolutions sum in other orders.
Each test states its bound in bf16 ulps (2^-7 of the binade) and the gap
measured on the CPU.
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
from tandem_tpu.ops.warp import plane_sweep_warp as j_warp
from tandem_tpu_torch.models.convert import flax_to_state_dict, load_variables
from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
from tandem_tpu_torch.ops.warp import plane_sweep_warp
from test_torch_mvsnet import (DEPTH_NUM, GOLDEN_TOL, H, REPO, V, W, _inputs,
                               _sub, live_gate, random_variables)

BF16 = torch.bfloat16
STAGES = ("stage1", "stage2", "stage3")


def _top_ulps(out, ref):
    """max |out - ref| in bf16 ulps of ref's largest magnitude."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    return float(np.abs(out - ref).max() / ulp)


@pytest.fixture(scope="module")
def models():
    """One random abl04-shaped parameter tree; the port's model in bf16
    loading the same float32 state_dict as the f32 model does."""
    jm = JCvaMVSNet(depth_num=DEPTH_NUM, view_aggregation=True,
                    dtype=jnp.bfloat16)
    variables = random_variables(
        JCvaMVSNet(depth_num=DEPTH_NUM, view_aggregation=True), H, W, V,
        seed=3)
    tm = CvaMVSNet(depth_num=DEPTH_NUM, view_aggregation=True,
                   dtype=BF16).eval()
    tm.load_state_dict(flax_to_state_dict(variables, True))
    return jm, variables, tm


def test_bf16_model_keeps_f32_weights(models):
    """The bf16 model holds the converted f32 state_dict as is (one copy of
    the weights) and casts where it uses them."""
    _, _, tm = models
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert tm.dtype == BF16 and tm.feature_net.dtype == BF16


def test_feature_net_bf16(models):
    """Within 4 ulps of each output's top binade (measured 0, 1 and 2 ulps
    at stages 1-3: eager torch rounds the folded BN's product and sum
    separately, XLA keeps the chain in f32)."""
    _, variables, tm = models
    x = np.random.RandomState(0).rand(2, H, W, 3).astype(np.float32)
    ref = JFeatureNet(dtype=jnp.bfloat16).apply(
        _sub(variables, "feature_net"), jnp.asarray(x))
    with torch.no_grad():
        out = tm.feature_net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for s in STAGES:
        assert out[s].dtype == BF16
        assert _top_ulps(out[s].permute(0, 2, 3, 1).float().numpy(),
                         ref[s]) <= 4, s


@pytest.mark.parametrize("stage,four", [("stage1", False), ("stage2", True)])
def test_cost_reg_net_bf16(models, stage, four):
    """D = 8 (stride-2 deepest level) and D = 4 (stride (1, 2, 2),
    output_padding (0, 1, 1)): within 4 ulps of the logits' top binade
    (measured 0 and 0.5 ulps)."""
    _, variables, tm = models
    D, C, s = (8, 32, 4) if stage == "stage1" else (4, 16, 2)
    x = np.random.RandomState(1).rand(1, D, H // s, W // s, C).astype(
        np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = JCostRegNet(has_four_depths=four, dtype=jnp.bfloat16).apply(
        _sub(variables, f"cost_reg_{stage}"), xb)[..., 0]
    with torch.no_grad():
        out = tm.cost_regularization_net[stage](
            torch.from_numpy(np.array(xb.astype(jnp.float32))).to(BF16)
            .permute(0, 4, 1, 2, 3))
    assert out.dtype == BF16 and out.shape == ref.shape
    assert _top_ulps(out.float().numpy(), ref) <= 4


def test_volume_gate_bf16(models):
    """The gate's C-contraction and scalar maps in bf16, with the sign flip
    of ``live_gate``: within 1 ulp of the top binade (measured: exact)."""
    _, variables, tm = models
    gate_vars, gate = live_gate(variables, tm, BF16)
    x = np.random.RandomState(2).rand(1, 8, 16, 24, 32).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = JVolumeGate(dtype=jnp.bfloat16).apply(gate_vars, xb)
    with torch.no_grad():
        out = gate(torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
            BF16))
    assert out.dtype == BF16
    assert (np.asarray(ref, np.float32) > 0).mean() > 0.2
    assert _top_ulps(out.float().numpy(), ref) <= 1


def test_plane_sweep_warp_bf16():
    """bf16 features through P5 + P3 against the JAX warp in bf16. Each
    sample is within 5 unit roundoffs (5 * 2^-8) of its terms' magnitude
    sum_k |g_k| w_k (the f32 warp of |features|) plus 2^-8 of the largest
    such magnitude for weights that round differently when the two
    frameworks' f32 positions differ in their last bit (measured: 63% of
    samples exact, the worst at 3.8 unit roundoffs of its terms)."""
    rng = np.random.RandomState(4)
    _, Ks, c2w, _, _ = _inputs(rng)
    feat = rng.randn(1, H // 2, W // 2, 16).astype(np.float32)
    featb = np.array(jnp.asarray(feat).astype(jnp.bfloat16)
                     .astype(jnp.float32))
    depth = (0.5 + 5 * rng.rand(1, 4, H // 2, W // 2)).astype(np.float32)
    kw = dict(src_K=Ks[1], src_cam_to_world=c2w[:, 2], ref_K=Ks[1],
              ref_cam_to_world=c2w[:, 0])
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    w_j, _ = j_warp(jnp.asarray(featb).astype(jnp.bfloat16),
                    jnp.asarray(depth),
                    **{k: jnp.asarray(v) for k, v in kw.items()})
    w_t, m_t = plane_sweep_warp(torch.from_numpy(featb).to(BF16),
                                torch.from_numpy(depth), **tkw)
    assert w_t.dtype == BF16 and m_t.dtype == BF16
    terms, _ = plane_sweep_warp(torch.from_numpy(np.abs(featb)),
                                torch.from_numpy(depth), **tkw)
    err = np.abs(w_t.float().numpy() - np.asarray(w_j.astype(jnp.float32)))
    bound = 5 * 2.0 ** -8 * terms.numpy() + 2.0 ** -8 * terms.numpy().max()
    assert np.all(err <= bound)


def test_cva_mvsnet_bf16(models):
    """The whole bf16 cascade with the edge filter against JAX bf16. The
    dense outputs (before the edge filter) agree within 5e-3 (measured
    max 1.4e-3 on depths in [0.5, 6], 3.2e-4 on confidences); the
    filtered outputs agree there too except where a pixel's edge value
    crosses the 10% threshold in one framework only (measured 0.5% of the
    pixels at stage 2, 0.4% at stage 3; bound 2%). Every output is
    float32."""
    jm, variables, tm = models
    image, Ks, c2w, dmin, dmax = _inputs(np.random.RandomState(6))
    disc = np.full((1,), 10.0, np.float32)
    ref = jax.jit(lambda v, *a: jm.apply(
        v, *a, depth_filter_discard_percentage=jnp.asarray(disc)))(
        variables, jnp.asarray(image), tuple(jnp.asarray(k) for k in Ks),
        jnp.asarray(c2w), jnp.asarray(dmin), jnp.asarray(dmax))
    out = tm(torch.from_numpy(image), [torch.from_numpy(k) for k in Ks],
             torch.from_numpy(c2w), torch.from_numpy(dmin),
             torch.from_numpy(dmax), torch.from_numpy(disc))
    for s in STAGES:
        for f in ("depth", "confidence", "depth_dense", "confidence_dense"):
            a = getattr(getattr(out, s), f)
            b = np.asarray(getattr(getattr(ref, s), f), np.float32)
            assert a.dtype == torch.float32 and a.shape == b.shape
            close = np.abs(a.numpy() - b) <= 5e-3
            if f.endswith("_dense"):
                assert close.all(), f"{s}.{f}"
            else:
                assert close.mean() >= 0.98, f"{s}.{f}: {close.mean()}"


@pytest.mark.slow
def test_trained_golden_512x320_bf16():
    """The trained unit in bf16 against the reference's f32 goldens: worst
    MAE over all 12 outputs within 10 x the boot-check bar, the JAX
    runtime's bf16 tolerance (tandem_tpu/cli/tandem_dataset.py:107-108;
    measured 5.6e-2 on the CPU, stage3.depth)."""
    unit = os.path.join(REPO, "exported", "tandem_512x320")
    with open(os.path.join(unit, "model_config.json")) as f:
        model = CvaMVSNet(**json.load(f), dtype=BF16).eval()
    model.load_state_dict(flax_to_state_dict(load_variables(
        os.path.join(unit, "model_variables.pkl"))))
    pack = np.load(os.path.join(unit, "sample_inputs.npz"))
    out = model(torch.from_numpy(pack["image"].astype(np.float32) / 255.0),
                [torch.from_numpy(pack[k]) for k in ("K1", "K2", "K3")],
                torch.from_numpy(pack["cam_to_world"]),
                torch.from_numpy(pack["depth_min"]),
                torch.from_numpy(pack["depth_max"]),
                torch.full((1,), float(pack["discard_percentage"])))
    worst = max(float(np.abs(getattr(getattr(out, s), f).numpy()
                             - pack[f"out.{s}.{f}"]).mean())
                for s in STAGES for f in ("depth", "confidence",
                                          "depth_dense", "confidence_dense"))
    assert worst < 10 * GOLDEN_TOL, f"bf16 golden MAE {worst:.2e}"
