"""The port's data-parallel training on the CPU: global BatchNorm
statistics, 2-rank train steps against one process on the global batch
and against the JAX mesh step, and the training CLI's multihost mode.

Ranks are spawned processes joined with gloo over a ``file://`` store under
``tmp_path`` (``parallel/dryrun.run_ranks``), so concurrent test workers
share no port; every wait has a timeout of at most 120 s. Small config:
planes (8, 8, 4), 64x64, tuples 0, 3, 7 and 10 of
tests/fixtures/replica_traj (a global batch of 4, 2 a rank).
"""

import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tandem_tpu import config as jcfg
from tandem_tpu.data.replica import MVSDataset as JMVSDataset
from tandem_tpu.data.replica import collate as jcollate
from tandem_tpu_torch import config as pcfg
from tandem_tpu_torch.data.replica import MVSDataset, collate
from tandem_tpu_torch.models.convert import flax_to_state_dict
from tandem_tpu_torch.models.layers import batch_norm_train
from tandem_tpu_torch.parallel.dryrun import (multihost_train_losses,
                                              run_ranks, train_rank,
                                              train_steps)
from tandem_tpu_torch.train import trainer as pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "replica_traj")
TUPLES = (0, 3, 7, 10)
SIZE = 64
# (N, C, H, W) and (N, C, D, H, W) as the 2D and 3D convolutions give
# them, and (1, 1, L) as the view-aggregation gate's BatchNorms do.
BN_SHAPES = ((4, 3, 5, 6), (4, 2, 3, 4, 5), (1, 1, 24))


@pytest.fixture(autouse=True)
def _two_threads():
    """The one-process references share the host with the spawned ranks
    (and other test workers): with every core's thread each, they ran
    ~20x slower on a loaded 8-core CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bn(x: np.ndarray, g: np.ndarray):
    """batch_norm_train on x (its scale, bias and running statistics drawn
    from a seed) with upstream gradient g: (y, dL/dx, running mean,
    running var)."""
    C = x.shape[1]
    bn = torch.nn.BatchNorm1d(C)
    gen = torch.Generator().manual_seed(C)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.3 * torch.randn(C, generator=gen))
        bn.bias.copy_(0.2 * torch.randn(C, generator=gen))
        bn.running_mean.copy_(0.1 * torch.randn(C, generator=gen))
        bn.running_var.copy_(0.5 + torch.rand(C, generator=gen))
    xt = torch.tensor(x, requires_grad=True)
    y = batch_norm_train(xt, bn)
    (y * torch.tensor(g)).sum().backward()
    return (y.detach(), xt.grad, bn.running_mean.detach().clone(),
            bn.running_var.detach().clone())


def _rows(a: np.ndarray, rank: int, world: int) -> np.ndarray:
    """A rank's share of a BatchNorm input: its rows, or for the gate's
    (1, 1, L) its part of the L axis."""
    axis = 0 if a.shape[0] % world == 0 else a.ndim - 1
    n = a.shape[axis] // world
    return np.take(a, np.arange(rank * n, (rank + 1) * n), axis=axis)


def _bn_rank(rank, world, init_method, cases):
    pt.init_process_group(torch.device("cpu"), init_method, world, rank)
    try:
        return [_bn(_rows(x, rank, world), _rows(g, rank, world))
                for x, g in cases]
    finally:
        torch.distributed.destroy_process_group()


def test_global_batch_norm_matches_one_process(tmp_path):
    """Under a 2-rank group every training BatchNorm normalizes with the
    global batch's statistics: each rank's output and input gradient equal
    one process's on the concatenated batch, and both ranks' running
    statistics equal its, within 1e-6. Each rank alone (no group) differs
    from that by more than 1e-3, so the test tells the two apart."""
    rng = np.random.RandomState(0)
    cases = [((rng.randn(*s) * 2 + rng.rand(s[1]).reshape(
        1, -1, *(1,) * (len(s) - 2)) * 3).astype(np.float32),
        rng.randn(*s).astype(np.float32)) for s in BN_SHAPES]
    ranks = run_ranks(_bn_rank, 2, tmp_path, (cases,), timeout=120)
    for i, (x, g) in enumerate(cases):
        y, gx, mean, var = _bn(x, g)
        axis = 0 if x.shape[0] % 2 == 0 else x.ndim - 1
        got_y = torch.cat([r[i][0] for r in ranks], axis)
        got_gx = torch.cat([r[i][1] for r in ranks], axis)
        torch.testing.assert_close(got_y, y, rtol=0, atol=1e-6)
        torch.testing.assert_close(got_gx, gx, rtol=0, atol=1e-6)
        for r in ranks:
            torch.testing.assert_close(r[i][2], mean, rtol=0, atol=1e-6)
            torch.testing.assert_close(r[i][3], var, rtol=0, atol=1e-6)
        alone = _bn(_rows(x, 0, 2), _rows(g, 0, 2))
        n = alone[0].shape[axis]
        assert float((alone[0] - y.narrow(axis, 0, n)).abs().max()) > 1e-3
        assert float((alone[2] - mean).abs().max()) > 1e-3


def _config(module, sam: bool = False):
    config = module.default()
    config.update({"MODEL.DEPTH_NUM": (8, 8, 4), "TRAIN.BATCH_SIZE": 2,
                   "DATA.IMG_HEIGHT": SIZE, "DATA.IMG_WIDTH": SIZE,
                   "TRAIN.SAM": sam})
    return config


def _batch(dataset, collate_fn):
    items = collate_fn([dataset(FIXTURE, "val", height=SIZE,
                                width=SIZE)[i] for i in TUPLES])
    return {k: items[k] for k in pt.BATCH_KEYS}


def _update(result, init):
    return torch.cat([(result["params"][n] - p).flatten().double()
                      for n, p in init.items()])


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("sam,steps", [(False, 3), (True, 1)])
def test_data_parallel_steps_match_one_process(tmp_path, sam, steps):
    """2 gloo ranks (2 rows each) against one process at world_size 2 on
    the global batch of 4, from the same seeded initialization: each
    step's loss within 5e-3 relative (the JAX mesh test's gate), the two
    ranks' parameters and running statistics equal, and the parameter
    update within twice what one ulp of the input image moves the one
    process's own (the f32 floor of this cascade after a few Adam steps:
    stage 1's softmax over hypotheses 10 m apart moves stages 2-3,
    tests/test_torch_train.py); printed with -s."""
    config = _config(pcfg, sam)
    batch = _batch(MVSDataset, collate)
    init = {n: p.detach().clone() for n, p in pt.create_train_state(
        config, torch.Generator().manual_seed(0), 200)[0]
        .named_parameters()}
    one = train_steps(config, batch, steps, "cpu", world_size=2)
    nudged = dict(batch, image=batch["image"] * np.float32(1 + 2 ** -23))
    ulp = train_steps(config, nudged, steps, "cpu", world_size=2)
    ranks = run_ranks(train_rank, 2, tmp_path,
                      (config, batch, steps, "cpu"), timeout=120)
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"],
                               rtol=5e-3)
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n
    for n, s in ranks[0]["stats"].items():
        assert torch.equal(s, ranks[1]["stats"][n]), n
    gap = _rel(_update(ranks[0], init), _update(one, init))
    floor = _rel(_update(ulp, init), _update(one, init))
    print(f"2 ranks vs one process: losses {ranks[0]['losses']} vs "
          f"{one['losses']}; update {gap:.3e}, one-ulp floor {floor:.3e}")
    assert gap <= max(1e-4, 2 * floor), (gap, floor)


def _jax_mesh_losses(config, batch, steps: int):
    """The JAX package's mesh step over 2 of the virtual CPU devices, from
    flax's initialization (key 0; jitted: op by op it takes ~90 s) with
    create_train_state's optimizer and schedule at world_size 2; returns
    (initial variables, losses)."""
    import optax

    from tandem_tpu.models.cva_mvsnet import CvaMVSNet as JCvaMVSNet
    from tandem_tpu.train.trainer import (TrainState, lr_schedule,
                                          make_mesh, make_train_step,
                                          shard_batch)
    model = JCvaMVSNet(depth_num=tuple(config["MODEL.DEPTH_NUM"]),
                       view_aggregation=config["MODEL.VIEW_AGGREGATION"])
    img = jnp.zeros((1, 2, 3, 32, 32), jnp.float32)
    Ks = tuple(jnp.broadcast_to(jnp.eye(3) * s, (1, 3, 3))
               for s in (100.0, 200.0, 400.0))
    c2w = jnp.broadcast_to(jnp.eye(4), (1, 2, 4, 4))
    variables = jax.jit(lambda k: model.init(
        k, img, Ks, c2w, jnp.full((1,), 0.5), jnp.full((1,), 10.0),
        train=True))(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tx = optax.adam(lr_schedule(
        config["TRAIN.LR"] * 2, 200,
        config["TRAIN.LR_SCHEDULE_FINAL_FRACTION"],
        warmup_steps=int(500 * 16 / (config["TRAIN.BATCH_SIZE"] * 2))))
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), tx=tx)
    mesh = make_mesh(2)
    step = make_train_step(model, config, mesh=mesh)
    losses = []
    with mesh:
        sharded = shard_batch(batch, mesh)
        for _ in range(steps):
            state, m = step(state, sharded)
            losses.append(float(m["loss"]))
    return variables, losses


@pytest.mark.slow
def test_data_parallel_matches_jax_mesh(tmp_path):
    """2 gloo ranks of the port against the JAX package's
    ``make_train_step(mesh=make_mesh(2))`` on the same global batch from
    the same initial weights (flax's, converted): 3 losses within 5e-3
    relative. Slow: the JAX side's two compiles take ~60 s on the CPU."""
    batch = _batch(JMVSDataset, jcollate)
    variables, want = _jax_mesh_losses(_config(jcfg), batch, 3)
    ranks = run_ranks(train_rank, 2, tmp_path,
                      (_config(pcfg), batch, 3, "cpu", None,
                       flax_to_state_dict(variables)), timeout=120)
    print(f"2 ranks: {ranks[0]['losses']}, JAX mesh: {want}")
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=5e-3)


def test_train_cli_multihost_on_the_cpu(tmp_path):
    """tandem_train with TRAIN.DEVICE multihost as 2 processes on the CPU
    (TANDEM_PLATFORM=cpu, gloo, parallel/dryrun.multihost_train_losses, 2
    steps, a global batch of 2): both ranks finish and print the same
    (step, loss) lines, and rank 0 alone writes the one checkpoint into
    the shared run directory."""
    losses = multihost_train_losses(2, str(tmp_path), max_steps=2,
                                    timeout=120)
    lines = [re.findall(r"step (\d+) loss ([0-9.]+)",
                        (tmp_path / f"rank{r}.log").read_text())
             for r in range(2)]
    assert lines[0] == lines[1] and len(lines[0]) == 2
    assert [float(v) for _, v in lines[0]] == losses
    assert np.isfinite(losses).all()
    assert os.listdir(tmp_path / "run" / "ckpt") == ["step_00000002"]


@pytest.mark.slow
def test_dryrun_multichip_on_the_cpu():
    """parallel/dryrun.dryrun_multichip(2) on the CPU in its own
    interpreter (~65 s): a data-parallel step over 2 gloo ranks, the
    view-sharded abl04 bf16 forward over 2 shards within 2e-2 of the
    monolithic one, and the multihost CLI over 2 processes against 1."""
    from tandem_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(2, "cpu", timeout=300)
    assert "2 ranks on cpu, loss=" in out
    assert "8 sums" in out and "1 process" in out
