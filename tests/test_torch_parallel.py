"""The port's view-sharded CVA-MVSNet forward against its monolithic forward
and against the JAX package's view-sharded program, on the CPU.

The port's shards are ``[cpu] * n`` of one process; the JAX program runs on
n of the 8 virtual CPU devices that tests/conftest.py provides. 64x96,
the default planes (48, 32, 8), random weights drawn with numpy into the
JAX parameter tree with non-trivial BatchNorm statistics
(``test_torch_mvsnet.random_variables``), converted by
``flax_to_state_dict``. Tolerances: tests/test_parallel.py's, atol/rtol
1e-4 on depth and 1e-3 on confidence. The port's sums are recorded where
they are issued (``parallel/collectives``) and must be the JAX program's
``stablehlo.all_reduce`` payloads entry by entry, with the same ring
bytes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from tandem_tpu.models.cva_mvsnet import CvaMVSNet as JCvaMVSNet
from tandem_tpu.parallel import build_view_sharded_forward as j_sharded
from tandem_tpu.parallel.collectives import (all_reduce_payloads,
                                             ici_bytes_per_chip)
from tandem_tpu.pipeline.mvsnet_runner import MvsnetRunner as JMvsnetRunner
from tandem_tpu_torch.models.convert import flax_to_state_dict
from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
from tandem_tpu_torch.parallel import build_view_sharded_forward, collectives
from tandem_tpu_torch.pipeline.mvsnet_runner import (ExportedRunner,
                                                     MvsnetRunner)
from tests.test_torch_mvsnet import random_variables

H, W = 64, 96
DEPTH = dict(rtol=1e-4, atol=1e-4)
CONF = dict(rtol=1e-3, atol=1e-3)


def _inputs(V, seed=0):
    """tests/test_parallel.py's inputs: random images, a camera moving
    0.05 along x and 0.01 along y a view."""
    rng = np.random.RandomState(seed)
    image = rng.rand(1, V, 3, H, W).astype(np.float32)
    K3 = np.array([[60.0, 0, (W - 1) / 2], [0, 60.0, (H - 1) / 2],
                   [0, 0, 1]], np.float32)
    Ks = []
    for s in (0.25, 0.5, 1.0):
        K = K3.copy()
        K[:2] *= s
        Ks.append(K[None])
    c2w = np.broadcast_to(np.eye(4, dtype=np.float32), (1, V, 4, 4)).copy()
    for v in range(V):
        c2w[0, v, 0, 3] = 0.05 * v
        c2w[0, v, 1, 3] = 0.01 * v
    return (image, Ks, c2w, np.full((1,), 0.5, np.float32),
            np.full((1,), 6.0, np.float32))


@pytest.mark.parametrize("view_agg,n_shards,V", [(True, 4, 7),
                                                 (False, 2, 5)])
def test_view_sharded_matches_monolithic_and_jax(view_agg, n_shards, V):
    """Depth and confidence against the port's monolithic forward and the
    JAX view-sharded program; the recorded sums equal the JAX program's
    all-reduce payloads (8 with view aggregation, 11 without) and
    ``link_bytes_per_card`` equals ``ici_bytes_per_chip``."""
    jmodel = JCvaMVSNet(view_aggregation=view_agg)
    variables = random_variables(jmodel, H, W, V, seed=5)
    image, Ks, c2w, dmin, dmax = _inputs(V)

    mesh = Mesh(np.array(jax.devices()[:n_shards]), axis_names=("view",))
    jfwd = j_sharded(jmodel, mesh)
    jargs = (variables, jnp.asarray(image),
             tuple(jnp.asarray(k) for k in Ks), jnp.asarray(c2w),
             jnp.asarray(dmin), jnp.asarray(dmax))
    jd, jc = (np.asarray(x) for x in jfwd(*jargs))
    text = jfwd.lower(*jargs).as_text()

    model = CvaMVSNet(view_aggregation=view_agg)
    model.load_state_dict(flax_to_state_dict(variables, view_agg))
    args = (torch.from_numpy(image), [torch.from_numpy(k) for k in Ks],
            torch.from_numpy(c2w), torch.from_numpy(dmin),
            torch.from_numpy(dmax))
    mono = model(*args).stage3
    fwd = build_view_sharded_forward(model, ["cpu"] * n_shards)
    with collectives.record() as payloads:
        d, c = fwd(*args)

    np.testing.assert_allclose(d.numpy(), mono.depth.numpy(), **DEPTH)
    np.testing.assert_allclose(c.numpy(), mono.confidence.numpy(), **CONF)
    np.testing.assert_allclose(d.numpy(), jd, **DEPTH)
    np.testing.assert_allclose(c.numpy(), jc, **CONF)

    assert sorted(payloads) == sorted(all_reduce_payloads(text))
    assert len(payloads) == (8 if view_agg else 11)
    ours = collectives.link_bytes_per_card(payloads, n_shards)
    theirs = ici_bytes_per_chip(text, n_shards)
    assert ours == {"payload_bytes": theirs["payload_bytes"],
                    "link_bytes": theirs["ici_bytes"],
                    "n_collectives": theirs["n_collectives"]}


def test_view_sharded_warps_only_source_views(monkeypatch):
    """The reference view's and the padded views' warps are skipped: the
    warp runs once a source view and stage (V = 5 over 4 shards: 8 views,
    3 of them padding), as on the monolithic path; a shard with no source
    view (V = 2 over 2 shards) still adds its zero volume to each sum."""
    from tandem_tpu_torch.parallel import view_shard
    calls = []
    real = view_shard.plane_sweep_warp

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)
    monkeypatch.setattr(view_shard, "plane_sweep_warp", counting)
    for V, n in ((5, 4), (2, 2)):
        model = CvaMVSNet(depth_num=(8, 4, 4), view_aggregation=True)
        image, Ks, c2w, dmin, dmax = _inputs(V, seed=1)
        args = (torch.from_numpy(image), [torch.from_numpy(k) for k in Ks],
                torch.from_numpy(c2w), torch.from_numpy(dmin),
                torch.from_numpy(dmax))
        calls.clear()
        with collectives.record() as payloads:
            d, _ = build_view_sharded_forward(model, ["cpu"] * n)(*args)
        assert len(calls) == 3 * (V - 1)
        assert len(payloads) == 8
        np.testing.assert_allclose(d.numpy(), model(*args).stage3.depth
                                   .numpy(), **DEPTH)


def test_mesh_runner_matches_single_device():
    """MvsnetRunner(devices=[cpu] * 4) serves the view-sharded cascade
    under the CallAsync/GetResult protocol: its dense depth and confidence
    against the single-device runner's and the JAX mesh runner's
    (tests/test_parallel.py::test_mesh_runner_matches_single_device), and
    its filtered depth against the single-device runner's (the same
    pixels zeroed, but for 0.1% at the threshold). ExportedRunner refuses
    devices=."""
    V = 5
    rng = np.random.RandomState(3)
    jmodel = JCvaMVSNet(view_aggregation=True)
    variables = random_variables(jmodel, H, W, V, seed=6)
    bgrs = [rng.randint(0, 255, (H, W, 3)).astype(np.uint8)
            for _ in range(V)]
    poses = []
    for v in range(V):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.04 * v
        poses.append(T)
    K = np.array([[60.0, 0, (W - 1) / 2], [0, 60.0, (H - 1) / 2],
                  [0, 0, 1]], np.float32)

    def run(runner):
        runner.call_async(bgrs, poses, K, 0.5, 6.0, discard_percentage=10.0)
        return runner.get_result()
    jmesh = Mesh(np.array(jax.devices()[:4]), axis_names=("view",))
    want = run(JMvsnetRunner(jmodel, variables, H, W, view_num=V,
                             mesh=jmesh))
    single = run(MvsnetRunner(CvaMVSNet(view_aggregation=True), variables,
                              H, W, view_num=V, device="cpu"))
    sharded = MvsnetRunner(CvaMVSNet(view_aggregation=True), variables, H,
                           W, view_num=V, devices=["cpu"] * 4)
    assert sharded.device == torch.device("cpu")
    got = run(sharded)
    for ref in (single, want):
        np.testing.assert_allclose(got["depth_dense"], ref["depth_dense"],
                                   **DEPTH)
        np.testing.assert_allclose(got["confidence_dense"],
                                   ref["confidence_dense"], **CONF)
    # The filter keeps a rank of the edge values: a pixel at the threshold
    # may go either way when the depths differ in the last bits.
    kept, kept1 = got["depth"] > 0, single["depth"] > 0
    assert (kept != kept1).mean() <= 1e-3
    np.testing.assert_allclose(got["depth"][kept & kept1],
                               single["depth"][kept & kept1], **DEPTH)
    with pytest.raises(ValueError, match="view-sharded"):
        ExportedRunner("unused", H, W, view_num=V, devices=["cpu"] * 2)
