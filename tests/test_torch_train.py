"""The port's training half against the JAX package: the LR schedule, the
losses and metrics, the plane-sweep sample's gradient, one train step from
the JAX package's initial parameters (loss, gradients, BatchNorm running
statistics with the gate's per-view chain) and SAM's two passes.

Small config, as tests/test_train_learns.py: planes (8, 8, 4), 96x128,
B = 2 (tuples 0 and 7 of tests/fixtures/replica_traj), f32 on the CPU.
Inputs come from numpy seeds and the fixture; tolerances are stated in
each test.

Why the step's gradient bars are two: stage 1's depth is a softmax over
hypotheses 10 m apart, so f32 rounding in the ~30 convolutions and training
BatchNorms before it moves it (the packages differ by 1.2e-4 m; one ulp of
the input image moves the port's by 3.7e-5 m: test_train_step_matches_jax
prints both); stage 2's and 3's hypotheses sit around that depth, and
their samples move with it. The gradient of the stage-1 loss
does not pass through that, and holds to 1e-4 per parameter. The gradient
of the full loss is held to five times what one ulp of the input image
moves the port's own gradient by (the f32 floor of this cascade).
"""

import functools
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tandem_tpu import config as jcfg
from tandem_tpu.data.replica import MVSDataset as JMVSDataset
from tandem_tpu.data.replica import collate as jcollate
from tandem_tpu.models import losses as jlosses
from tandem_tpu.models import metrics as jmetrics
from tandem_tpu.models.cva_mvsnet import CvaMVSNet as JCvaMVSNet
from tandem_tpu.models.cva_mvsnet import outputs_to_dict as j_outputs_to_dict
from tandem_tpu.ops.warp import plane_sweep_warp as j_warp
from tandem_tpu.train import utils as jutils
from tandem_tpu.train.trainer import lr_schedule as j_lr_schedule
from tandem_tpu_torch import config as pcfg
from tandem_tpu_torch.models import losses as plosses
from tandem_tpu_torch.models import metrics as pmetrics
from tandem_tpu_torch.models.convert import flax_to_state_dict
from tandem_tpu_torch.ops.bilinear_sample import (warp_sample,
                                                  warp_sample_grad,
                                                  warp_sample_grad_plain,
                                                  warp_sample_plain)
from tandem_tpu_torch.ops.warp import plane_sweep_warp, ref_to_src_matrix
from tandem_tpu_torch.train import trainer as pt
from tandem_tpu_torch.train import utils as putils
from tandem_tpu_torch.train.utils import sam_perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "replica_traj")
H, W = 96, 128
STAGES = ("stage1", "stage2", "stage3")
# A parameter's gradient is held to 1e-4 relative L2 of the larger of its
# own norm and GRAD_FLOOR x the whole gradient's norm: some are zero at
# flax's initialization (the gate's convolution biases feed training
# BatchNorms, which remove any shift; the gate's first BatchNorm scale and
# second convolution weight are scale-invariant through the second
# BatchNorm while the shift they scale along with is 0), and both packages
# return rounding noise there, ~1e-9 of the whole gradient.
GRAD_FLOOR = 1e-2


def _small_config(module):
    config = module.default()
    config.update({"MODEL.DEPTH_NUM": (8, 8, 4), "TRAIN.BATCH_SIZE": 2,
                   "DATA.IMG_HEIGHT": H, "DATA.IMG_WIDTH": W})
    return config


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def test_lr_schedule_matches_jax():
    """The same function of the step, value for value: the JAX package's
    schedule evaluated op by op (f32 IEEE operations in its order) equals
    the port's bit for bit, warmup included. (Under jit, XLA turns its
    divisions by constants into multiplications by reciprocals, which moves
    ~10% of the values by up to 2e-6 relative.)"""
    for base, total, final, warm in ((1e-3, 200, 0.01, 0), (2e-3, 50, 0.1, 7),
                                     (1e-3, 1, 0.01, 500), (3e-4, 600, 0.01,
                                                            500)):
        j = j_lr_schedule(base, total, final, warmup_steps=warm)
        p = pt.lr_schedule(base, total, final, warmup_steps=warm)
        steps = list(range(0, 12)) + list(range(12, max(total, warm) + 20, 7))
        got = np.array([p(s) for s in steps], np.float32)
        want = np.array([np.asarray(j(jnp.int32(s))) for s in steps],
                        np.float32)
        np.testing.assert_array_equal(got, want)


def test_train_utils_match_jax():
    """train/utils.py against the JAX package's: the epoch means (nested,
    per dataset name), the meter, the streaming histogram and the
    warmup multi-step LR (both evaluated op by op in f32: equal), and
    SAM's offsets (global norm over all tensors: 1e-6 relative)."""
    rng = np.random.RandomState(4)
    outs = [{"loss": rng.rand(), "stage1": {"abs_rel": rng.rand(3)}}
            for _ in range(5)]
    names = ["a", "b", "a", ("b",), "a"]
    assert putils.epoch_end_mean(outs) == jutils.epoch_end_mean(outs)
    assert putils.epoch_end_mean_named(outs, names) == \
        jutils.epoch_end_mean_named(outs, names)
    pm, jm = putils.DictAverageMeter(), jutils.DictAverageMeter()
    ph, jh = putils.StreamingBinCount(7), jutils.StreamingBinCount(7)
    for o in outs:
        pm.update({"loss": torch.tensor(o["loss"], dtype=torch.float64)})
        jm.update({"loss": o["loss"]})
        ph.update(torch.tensor(o["stage1"]["abs_rel"]))
        jh.update(o["stage1"]["abs_rel"])
    assert pm.mean() == pytest.approx(jm.mean(), rel=1e-12)
    np.testing.assert_array_equal(ph.normalized(), jh.normalized())
    jw = jutils.warmup_multi_step_lr(1e-3, (30, 10), warmup_iters=25)
    pw = putils.warmup_multi_step_lr(1e-3, (30, 10), warmup_iters=25)
    for step in (0, 1, 7, 10, 24, 25, 29, 30, 31, 60):
        assert np.float32(pw(step)) == np.asarray(jw(jnp.int32(step)))
    params = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(
        np.float32)]
    grads = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(
        np.float32)]
    want = jutils.sam_perturb([jnp.asarray(p) for p in params],
                              [jnp.asarray(g) for g in grads], rho=0.05)
    offsets = sam_perturb([torch.tensor(p) for p in params],
                          [torch.tensor(g) for g in grads], rho=0.05)
    for p, e, w in zip(params, offsets, want):
        np.testing.assert_allclose(p + e.numpy(), np.asarray(w), rtol=1e-6)


def test_train_state_schedule_and_optimizer():
    """create_train_state's LambdaLR gives the schedule's LR at every step
    (warmup int(500 * 16 / B), LR scaled by the world size) and Adam has
    optax's constants."""
    config = _small_config(pcfg)
    model, state = pt.create_train_state(config, torch.Generator()
                                         .manual_seed(0), 300, world_size=2)
    sched = pt.lr_schedule(2 * config["TRAIN.LR"], 300,
                           config["TRAIN.LR_SCHEDULE_FINAL_FRACTION"],
                           warmup_steps=int(500 * 16 / 4))
    for step in range(5):
        assert pt.current_lr(state) == pytest.approx(sched(step), rel=1e-12)
        state.optimizer.step()
        state.scheduler.step()
    group = state.optimizer.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8


def test_flax_initializers():
    """create_train_state draws flax's initializers: truncated-normal
    convolutions with std sqrt(1 / fan_in) (within [-2, 2] of the unit
    normal before the 1/0.8796 correction), uniform transposed ones within
    sqrt(1 / fan_in), zero biases, BatchNorm at 1, 0, 0, 1; the same
    generator seed gives the same model. Sample std within 10% on the
    larger kernels."""
    config = _small_config(pcfg)
    m1, _ = pt.create_train_state(config, torch.Generator().manual_seed(3), 10)
    m2, _ = pt.create_train_state(config, torch.Generator().manual_seed(3), 10)
    for (n, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), n
    checked = 0
    for m in m1.modules():
        if isinstance(m, torch.nn.ConvTranspose3d):
            fan_in = m.weight.shape[0] * 27
            assert float(m.weight.abs().max()) <= (1 / fan_in) ** 0.5
        elif isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d)):
            fan_in = m.weight[0].numel()
            std = (1 / fan_in) ** 0.5
            assert float(m.weight.abs().max()) <= 2 * std / 0.87962566 + 1e-7
            if m.weight.numel() >= 2000:
                assert abs(float(m.weight.std()) / std - 1) < 0.1
                checked += 1
            assert m.bias is None or not m.bias.any()
        elif isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            assert (m.weight == 1).all() and not m.bias.any()
            assert not m.running_mean.any() and (m.running_var == 1).all()
    assert checked > 10


@pytest.mark.parametrize("term", ["l1_depth", "sl1", "berhu", "abs_rel",
                                  "grad"])
def test_loss_terms_match_jax(term):
    """Each loss term per stage and compute_loss (mask_total and keep_batch
    included) within 1e-6 relative of the JAX package's."""
    rng = np.random.RandomState(5)
    gt = (rng.rand(2, 12, 16) * 4 + 0.5).astype(np.float32)
    est = (gt + rng.randn(2, 12, 16) * 0.3).astype(np.float32)
    mask = (rng.rand(2, 12, 16) > 0.3).astype(np.float32)
    for stage in STAGES:
        j = np.asarray(jlosses._LOSS_FNS[term](jnp.asarray(est),
                                              jnp.asarray(gt),
                                              jnp.asarray(mask), stage=stage))
        p = plosses._LOSS_FNS[term](torch.tensor(est), torch.tensor(gt),
                                    torch.tensor(mask), stage=stage).numpy()
        np.testing.assert_allclose(p, j, rtol=1e-6, atol=0)
    outs = {s: {"depth": est * (1 + 0.1 * i)} for i, s in enumerate(STAGES)}
    batch = {"depth": {s: gt for s in STAGES},
             "mask_total": {s: mask for s in STAGES}}
    kw = dict(weights=(1.0, 0.5, 2.0), loss_terms=(term, "l1_depth"),
              term_weights=(0.7, 0.3))
    for keep in (False, True):
        jt, jl = jlosses.compute_loss(
            jax.tree_util.tree_map(jnp.asarray, outs),
            jax.tree_util.tree_map(jnp.asarray, batch), keep_batch=keep, **kw)
        ptot, pl = plosses.compute_loss(
            jax.tree_util.tree_map(torch.tensor, outs),
            jax.tree_util.tree_map(torch.tensor, batch), keep_batch=keep, **kw)
        assert set(pl) == set(jl)
        np.testing.assert_allclose(ptot.numpy(), np.asarray(jt), rtol=1e-6)
        for k in jl:
            np.testing.assert_allclose(pl[k].numpy(), np.asarray(jl[k]),
                                       rtol=1e-6)


def test_eval_errors_match_jax():
    """All 11 metrics of every stage within 1e-6 relative (per sample and
    batch mean), with masked and empty pixels."""
    rng = np.random.RandomState(8)
    batch, outs = {"depth": {}, "mask": {}}, {}
    for i, s in enumerate(STAGES):
        shape = (3, 6 * 2 ** i, 8 * 2 ** i)
        gt = (rng.rand(*shape) * 4 + 0.3).astype(np.float32)
        mask = (rng.rand(*shape) > 0.4).astype(np.float32)
        mask[2] = 0.0                      # a sample with no valid pixel
        batch["depth"][s] = np.where(mask > 0, gt, 0).astype(np.float32)
        batch["mask"][s] = mask
        outs[s] = {"depth": (gt * (1 + 0.2 * rng.randn(*shape))).astype(
            np.float32)}
    for keep in (False, True):
        j = jmetrics.eval_errors(jax.tree_util.tree_map(jnp.asarray, outs),
                                 jax.tree_util.tree_map(jnp.asarray, batch),
                                 keep_batch=keep)
        p = pmetrics.eval_errors(jax.tree_util.tree_map(torch.tensor, outs),
                                 jax.tree_util.tree_map(torch.tensor, batch),
                                 keep_batch=keep)
        for s in STAGES:
            assert set(p[s]) == set(jmetrics.METRIC_NAMES)
            for k in jmetrics.METRIC_NAMES:
                np.testing.assert_allclose(p[s][k].numpy(),
                                           np.asarray(j[s][k]), rtol=1e-6,
                                           atol=1e-7, err_msg=f"{s} {k}")


# The abl04 stage shapes (planes, H, W, channels), cut to 1/8 of 640x480.
GRAD_SHAPES = {"stage1": (48, 15, 20, 32), "stage2": (4, 30, 40, 16),
               "stage3": (4, 60, 80, 8)}


@pytest.mark.parametrize("stage", STAGES)
def test_sample_gradient_matches_jax_autodiff(stage):
    """The plain sample's gradient (autograd of warp_sample_plain, and
    warp_sample_grad's plain version, which the op's registered autograd
    runs on the CPU) equals jax.grad of the JAX package's plane_sweep_warp
    with respect to the source features, at the three stage shapes
    (small), with part of the sweep behind the source camera and outside
    its image: 5e-5 of the largest |gradient|. The two packages compute
    the ref->src matrix in another order, which moves the positions by
    ~1e-5 px (the forwards differ by up to 3e-5 of the largest |feature|;
    JAX's eager and jitted gradients by 1.9e-5 of the largest). The
    port's two plain gradients (autograd, and the scatter of
    ``warp_sample_grad``) agree within 1e-6 of it."""
    D, Hs, Ws, C = GRAD_SHAPES[stage]
    rng = np.random.RandomState(11)
    feat = rng.randn(2, Hs, Ws, C).astype(np.float32)
    K = np.array([[Ws * 0.9, 0, Ws / 2], [0, Ws * 0.9, Hs / 2], [0, 0, 1]],
                 np.float32)
    Ks = np.stack([K, K])
    ref = np.stack([np.eye(4, dtype=np.float32)] * 2)
    src = ref.copy()
    src[:, :3, 3] = [[0.3, -0.1, 0.05], [-0.2, 0.15, 0.6]]
    ang = 0.05
    src[1, :3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]]
    depth = (rng.rand(2, D, Hs, Ws) * 3 + 0.2).astype(np.float32)
    gout = rng.randn(2, D, Hs, Ws, C).astype(np.float32)

    def jf(f):
        out, _ = j_warp(f, jnp.asarray(depth), src_K=jnp.asarray(Ks),
                        src_cam_to_world=jnp.asarray(src),
                        ref_K=jnp.asarray(Ks),
                        ref_cam_to_world=jnp.asarray(ref))
        return jnp.sum(out * jnp.asarray(gout))
    want = np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(feat)))

    f = torch.tensor(feat, requires_grad=True)
    kw = dict(src_K=torch.tensor(Ks), src_cam_to_world=torch.tensor(src),
              ref_K=torch.tensor(Ks), ref_cam_to_world=torch.tensor(ref))
    out, _ = plane_sweep_warp(f, torch.tensor(depth), with_mask=False, **kw)
    plain, = torch.autograd.grad(out, f, torch.tensor(gout))
    mat = ref_to_src_matrix(kw["src_K"], kw["src_cam_to_world"], kw["ref_K"],
                            kw["ref_cam_to_world"])
    got, = torch.autograd.grad(warp_sample_plain(f, mat, torch.tensor(depth)),
                               f, torch.tensor(gout))
    assert torch.equal(plain, warp_sample_grad(torch.tensor(gout), mat,
                                               torch.tensor(depth)))
    top = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5 * top)
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=0,
                               atol=1e-6 * top)
    assert np.abs(want).max() > 1.0 and (want == 0).any()


def test_sample_gradient_in_one_cell_matches_jax_autodiff():
    """The regime the card's gradient kernel sums in registers: sorted
    depths within 1 mm of 2 m and a source camera moved ~1 cm, so all 16
    planes of a pixel land in one source cell. warp_sample_grad's plain
    version equals jax.grad of the JAX package's plane_sweep_warp with
    respect to the source features (24x32, C = 8, B = 2) within 5e-5 of
    the largest |gradient|, the tolerance of
    test_sample_gradient_matches_jax_autodiff and for its reason."""
    from tandem_tpu_torch.ops.bilinear_sample import sweep_positions
    D, Hs, Ws, C = 16, 24, 32, 8
    rng = np.random.RandomState(12)
    feat = rng.randn(2, Hs, Ws, C).astype(np.float32)
    K = np.array([[Ws * 0.9, 0, Ws / 2], [0, Ws * 0.9, Hs / 2], [0, 0, 1]],
                 np.float32)
    Ks = np.stack([K, K])
    ref = np.stack([np.eye(4, dtype=np.float32)] * 2)
    src = ref.copy()
    src[:, :3, 3] = [[0.01, 0.004, 0.0], [-0.008, -0.006, 0.0]]
    depth = np.sort(2.0 + 1e-3 * rng.rand(2, D, Hs, Ws), axis=1).astype(
        np.float32)
    gout = rng.randn(2, D, Hs, Ws, C).astype(np.float32)

    def jf(f):
        out, _ = j_warp(f, jnp.asarray(depth), src_K=jnp.asarray(Ks),
                        src_cam_to_world=jnp.asarray(src),
                        ref_K=jnp.asarray(Ks),
                        ref_cam_to_world=jnp.asarray(ref))
        return jnp.sum(out * jnp.asarray(gout))
    want = np.asarray(jax.jit(jax.grad(jf))(jnp.asarray(feat)))

    mat = ref_to_src_matrix(torch.tensor(Ks), torch.tensor(src),
                            torch.tensor(Ks), torch.tensor(ref))
    px, py, _ = sweep_positions(mat, torch.tensor(depth), Hs, Ws)
    cell = py.floor() * (Ws + 2) + px.floor()
    assert bool((cell == cell[:, :1]).all())
    got = warp_sample_grad(torch.tensor(gout), mat, torch.tensor(depth))
    top = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5 * top)
    assert top > 1.0


def test_sample_gradient_contract():
    """warp_sample raises when the matrix or the depths want a gradient;
    warp_sample_grad returns float32 sums for either dtype of grad_out, and
    they agree with float64 sums."""
    rng = np.random.RandomState(2)
    img = torch.tensor(rng.randn(1, 9, 11, 4).astype(np.float32))
    mat = torch.tensor([[[1.01, 0.0, 0.3, 0.1], [0.0, 0.99, -0.2, 0.0],
                         [0.0, 0.0, 1.0, 0.02]]])
    depth = torch.tensor(rng.rand(1, 3, 9, 11).astype(np.float32) + 0.5)
    with pytest.raises(ValueError, match="no gradient"):
        warp_sample(img, mat.clone().requires_grad_(), depth)
    with pytest.raises(ValueError, match="no gradient"):
        warp_sample(img, mat, depth.clone().requires_grad_())
    gout = torch.tensor(rng.randn(1, 3, 9, 11, 4).astype(np.float32))
    acc = warp_sample_grad(gout.bfloat16(), mat, depth)
    assert acc.dtype == torch.float32
    assert torch.equal(acc, warp_sample_grad_plain(gout.bfloat16(), mat,
                                                   depth))
    with pytest.raises(ValueError):
        warp_sample_grad(gout, mat, depth[:, :, :-1].contiguous())
    f64 = warp_sample_grad_plain(gout.double(), mat, depth,
                                 acc_dtype=torch.float64)
    got = warp_sample_grad(gout, mat, depth)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got, f64, rtol=0, atol=1e-6)


# --- one train step from the JAX package's initial parameters -------------

@functools.lru_cache(maxsize=1)
def _jax_step():
    """The JAX package's initial variables (flax init of the model
    create_train_state builds, key PRNGKey(0): flax draws each parameter
    from the key and its module path, not from the example input, so a
    32x32 two-view example gives create_train_state's values, at a fraction
    of the compile time), the fixture batch, and jax.jacrev of the three
    stage losses with the updated batch_stats."""
    jconfig = _small_config(jcfg)
    model = JCvaMVSNet(
        depth_num=tuple(jconfig["MODEL.DEPTH_NUM"]),
        depth_interval_ratio=tuple(jconfig["MODEL.DEPTH_INTERVAL_RATIO"]),
        feature_net_base_channels=jconfig["MODEL.FEATURE_NET_BASE_CHANNELS"],
        cost_volume_base_channels=tuple(
            jconfig["MODEL.COST_VOLUME_BASE_CHANNELS"]),
        view_aggregation=jconfig["MODEL.VIEW_AGGREGATION"])
    img = jnp.zeros((1, 2, 3, 32, 32), jnp.float32)
    Ks = tuple(jnp.broadcast_to(jnp.eye(3) * s, (1, 3, 3))
               for s in (100.0, 200.0, 400.0))
    c2w = jnp.broadcast_to(jnp.eye(4), (1, 2, 4, 4))
    variables = jax.jit(lambda k: model.init(
        k, img, Ks, c2w, jnp.full((1,), 0.5), jnp.full((1,), 10.0),
        train=True))(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, variables)

    ds = JMVSDataset(FIXTURE, "val", height=H, width=W)
    items = jcollate([ds[0], ds[7]])
    batch = {k: items[k] for k in pt.BATCH_KEYS}

    def stage_losses(params, stats, batch):
        outputs, mutated = model.apply(
            {"params": params, "batch_stats": stats}, batch["image"],
            tuple(batch["intrinsics"][s]["K"][:, 0] for s in STAGES),
            batch["cam_to_world"], batch["depth_min"], batch["depth_max"],
            train=True, mutable=["batch_stats"])
        out = j_outputs_to_dict(outputs)
        return jnp.stack([jnp.mean(jlosses.l1_depth_loss(
            out[s]["depth"], batch["depth"][s], batch["mask"][s]))
            for s in STAGES]), (mutated["batch_stats"],
                                out["stage1"]["depth"])

    @jax.jit
    def step(params, stats, batch):
        losses, vjp, new_stats = jax.vjp(
            lambda p: stage_losses(p, stats, batch), params, has_aux=True)
        return losses, [vjp(jnp.eye(3)[i])[0] for i in range(3)], new_stats
    losses, grads, (new_stats, depth1) = step(
        variables["params"], variables["batch_stats"],
        jax.tree_util.tree_map(jnp.asarray, batch))
    grads = [jax.tree_util.tree_map(np.asarray, g) for g in grads]
    return (variables, batch, np.asarray(losses), grads,
            jax.tree_util.tree_map(np.asarray, new_stats), np.asarray(depth1))


def _port_step(variables, batch, image_scale: float = 1.0):
    """Port: the model from the JAX variables, one training forward, the
    three stage losses' gradients; returns (losses, grads per stage, the
    running statistics after the forward, stage 1's depth)."""
    config = _small_config(pcfg)
    model = pt.model_from_config(config)
    model.load_state_dict(flax_to_state_dict(variables))
    tb = pt.batch_to_device(batch, "cpu")
    tb["image"] = tb["image"] * image_scale
    out = pt.forward_outputs(model, tb, train=True)
    stats = {n: b.clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    losses, grads = [], []
    for i, s in enumerate(STAGES):
        loss = plosses.l1_depth_loss(out[s]["depth"], tb["depth"][s],
                                     tb["mask"][s]).mean()
        g = torch.autograd.grad(loss, list(model.parameters()),
                                retain_graph=i < 2, allow_unused=True)
        grads.append({n: (torch.zeros_like(p) if gi is None else gi)
                      for (n, p), gi in zip(model.named_parameters(), g)})
        losses.append(float(loss.detach()))
    return np.array(losses), grads, stats, out["stage1"]["depth"].detach()


def _flat(g, names=None):
    return torch.cat([g[n].double().flatten() for n in (names or g)])


def test_train_step_matches_jax():
    """One step at the small config, from JAX's initial parameters:

    - each stage's loss within 1e-5 relative (measured ~4e-7);
    - the stage-1 loss's gradient within 1e-4 relative L2 for every
      parameter, relative to the larger of its norm and GRAD_FLOOR of the
      whole gradient's (measured 4.5-4.6e-5);
    - the full loss's gradient (the stages' mean, compute_loss with
      weights 1, 1, 1), relative L2 over all parameters and for each (with
      the same floor), within the larger of 1e-4 and 5x the cascade's f32
      floor: what one ulp of the input image moves the port's own gradient
      by (measured: JAX vs port 1.2e-3 over all, the floor 2.0e-3; the
      worst parameter 3.2x its floor);
    - every BatchNorm running statistic after the step's forward, the
      gates' chained over the 6 source views, within the larger of 1e-5
      and 5x its one-ulp floor, relative L2 (measured <= 1.1e-5, 1.1x its
      floor).
    """
    variables, batch, jloss, jgrads, jstats, jdepth1 = _jax_step()
    ploss, pgrads, pstats, pdepth1 = _port_step(variables, batch)
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)

    J = [flax_to_state_dict({"params": g, "batch_stats": jstats})
         for g in jgrads]
    floor1 = GRAD_FLOOR * float(_flat(J[0], pgrads[0]).norm())
    worst = 0.0
    for n, g in pgrads[0].items():
        rel = float((g.double() - J[0][n].double()).norm()) / max(
            float(J[0][n].norm()), floor1)
        worst = max(worst, rel)
        assert rel <= 1e-4, (n, rel)
    print(f"stage-1 gradient: worst relative L2 {worst:.3e}")

    names = list(pgrads[0])

    def full(grads):
        return {n: sum(g[n].double() for g in grads) / 3 for n in names}
    pfull, jfull = full(pgrads), full(J)
    _, ulp_grads, ulp_stats, ulp_depth1 = _port_step(variables, batch,
                                                     1 + 2 ** -23)
    print(f"stage-1 depth: JAX vs port max "
          f"{float((pdepth1 - torch.tensor(jdepth1)).abs().max()):.2e} m, "
          f"one ulp of the input image moves the port's by "
          f"{float((ulp_depth1 - pdepth1).abs().max()):.2e} m")
    ufull = full(ulp_grads)
    floor = _rel(_flat(ufull), _flat(pfull))
    gap = _rel(_flat(pfull), _flat(jfull))
    print(f"full gradient: JAX vs port {gap:.3e}, one-ulp floor {floor:.3e}")
    assert gap <= max(1e-4, 5 * floor), (gap, floor)
    floor_all = GRAD_FLOOR * float(_flat(jfull).norm())
    worst = 0.0
    for n in names:
        den = max(float(jfull[n].norm()), floor_all)
        rel = float((pfull[n] - jfull[n]).norm()) / den
        ulp = float((ufull[n] - pfull[n]).norm()) / den
        worst = max(worst, rel / max(1e-4, ulp))
        assert rel <= max(1e-4, 5 * ulp), (n, rel, ulp)
    print(f"full gradient: worst parameter {worst:.2f}x its floor")
    worst = (0.0, 0.0)
    for n, v in pstats.items():
        rel, ulp = _rel(v, J[0][n]), _rel(ulp_stats[n], v)
        worst = max(worst, (rel, rel / max(1e-5, ulp)))
        assert rel <= max(1e-5, 5 * ulp), (n, rel, ulp)
    print(f"running statistics: worst relative L2 {worst[0]:.2e} "
          f"({worst[1]:.2f}x its floor)")


def test_sam_step_two_pass_semantics():
    """TRAIN.SAM's step (test_sam_step_two_pass_semantics of the JAX
    package, on the port, from its own seeded initialization at 64x96,
    B = 1): under SGD(1.0) the update must land on the hand-rolled two-pass
    point (the gradient at params + rho g / ||g||, from the same BatchNorm
    statistics, applied at the base point) — 5% of its distance to the
    plain step's point at most — and differ from the plain step. The
    running statistics are the second pass's, from the state's: 5% of
    their distance to the first pass's at most (CPU convolution gradients
    are not bit-reproducible from run to run, and the cascade carries
    that into stages 2-3, so the two runs' statistics are not equal)."""
    config = _small_config(pcfg)
    config.update({"TRAIN.SAM": True, "TRAIN.SAM_RHO": 0.05,
                   "DATA.IMG_HEIGHT": 64, "DATA.IMG_WIDTH": 96,
                   "TRAIN.BATCH_SIZE": 1})
    loss_cfg = pt.loss_config(config)
    ds = JMVSDataset(FIXTURE, "val", height=64, width=96)
    tb = pt.batch_to_device(jcollate([ds[0]]), "cpu")

    def fresh():
        model, _ = pt.create_train_state(config, torch.Generator()
                                         .manual_seed(1), 50)
        return model
    # Hand-rolled: two explicit forward-backward passes.
    ref = fresh()
    params = list(ref.parameters())
    base = [p.detach().clone() for p in params]
    pt.loss_and_grads(ref, tb, loss_cfg)
    g1 = [p.grad.clone() for p in params]
    stats1 = {n: b.clone() for n, b in ref.named_buffers() if "running" in n}
    with torch.no_grad():
        for p, e in zip(params, sam_perturb(params, g1, rho=0.05)):
            p.add_(e)
        for n, b in fresh().named_buffers():
            if "running" in n:
                ref.get_buffer(n).copy_(b)
    pt.loss_and_grads(ref, tb, loss_cfg)
    g2 = [p.grad.clone() for p in params]
    expect = [b - g for b, g in zip(base, g2)]
    plain = [b - g for b, g in zip(base, g1)]
    stats2 = {n: b.clone() for n, b in ref.named_buffers() if "running" in n}

    model = fresh()
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    state = pt.TrainState(model, opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: 1.0))
    state, _ = pt.make_train_step(model, config, with_metrics=False)(state,
                                                                      tb)
    got = [p.detach() for p in model.parameters()]

    def dist(a, b):
        return float(torch.sqrt(sum(((x - y).double() ** 2).sum()
                                    for x, y in zip(a, b))))
    d_impl, d_wiring = dist(got, expect), dist(got, plain)
    assert d_wiring > 1e-4, "SAM step equals the plain step: not wired"
    assert d_impl < 0.05 * d_wiring, (d_impl, d_wiring)
    got_stats = {n: b for n, b in model.named_buffers() if "running" in n}
    d_stats = dist(got_stats.values(), stats2.values())
    d_first = dist(got_stats.values(), [stats1[n] for n in got_stats])
    print(f"SAM: {d_impl / d_wiring:.2e} of the way to the plain step; "
          f"statistics {d_stats / d_first:.2e} of the way to pass 1's")
    assert d_stats < 0.05 * d_first, (d_stats, d_first)
