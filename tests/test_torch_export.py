"""The port's tandem_export on the CPU: the deployable unit, its
``torch.export`` program (model.pt2), ``ExportedRunner`` and a weightless
unit booting tandem_dataset.

Small scale: 64x96, V = 4, depth planes (8, 4, 4), the variables of the
JAX package's ``init_variables`` for that model. The port's ``run_model``
is held to the JAX package's on the same variables and window within
``tests/test_torch_mvsnet.py``'s ATOL (1e-4, f32). The saved program must
replay the golden pack under GOLDEN_TOL (1e-2 worst MAE, the reference's
boot bar) and hold the hand kernels as the custom-op nodes
``tandem::warp_sample`` and ``tandem::edge_filter``: a graph with the plain
warp baked in (its floor and index ops) would run the plain version on the
card. The custom ops pass ``torch.library.opcheck``.
"""

import collections
import pickle
import shutil

import numpy as np
import pytest
import torch

import jax

from tandem_tpu.cli import tandem_export as jax_export
from tandem_tpu.models.cva_mvsnet import CvaMVSNet as JCvaMVSNet
from tandem_tpu.pipeline.mvsnet_runner import init_variables
from tandem_tpu.train.checkpoint import load_any as jax_load_any
from tandem_tpu_torch.cli import tandem_dataset
from tandem_tpu_torch.cli import tandem_export as te
from tandem_tpu_torch.cli.golden import GOLDEN_TOL
from tandem_tpu_torch.ops import bilinear_sample  # noqa: F401 (the ops)
from tandem_tpu_torch.ops.edge_kth import discard_ranks, edge_kth_plain
from tandem_tpu_torch.pipeline.mvsnet_runner import ExportedRunner
from tests.test_coarse_tracker import H as SEQ_H, W as SEQ_W
from tests.test_torch_cli import (  # noqa: F401 (fixtures)
    _argv, _check_result, _one_torch_thread, sequence)
from tests.test_torch_mvsnet import ATOL

H, W, V = 64, 96, 4
DEPTH_NUM = "8,4,4"


def _args(out_dir, *extra):
    return te.parser.parse_args(
        ["--ckpt", str(out_dir / "in.pkl"), "--out-dir", str(out_dir),
         "--width", str(W), "--height", str(H), "--view-num", str(V),
         "--depth-num", DEPTH_NUM, "--device", "cpu", *extra])


@pytest.fixture(scope="module")
def variables():
    """init_variables of the JAX package's model (jitted: ~15 s on the CPU
    against ~70 s op by op), as numpy."""
    model = JCvaMVSNet(depth_num=(8, 4, 4), view_aggregation=True)
    tree = jax.jit(lambda: init_variables(model, H, W, V))()
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def unit(variables, tmp_path_factory):
    """The unit main(--device cpu) writes from a pickle of the variables,
    and main's result (the two replays' errors)."""
    out = tmp_path_factory.mktemp("unit")
    with open(out / "in.pkl", "wb") as f:
        pickle.dump(variables, f)
    res = te.main(_args(out))
    return out, res


def test_run_model_matches_jax(variables, tmp_path):
    """All 12 outputs within ATOL of the JAX package's run_model. The edge
    filter masks by rank: where the two dense depths differ by e (~1e-6),
    an edge value and the threshold each move by at most 2e, so a pixel
    whose edge lies within 4e of the threshold may be masked on one side
    only. Such flips are allowed (2 of 1536 pixels at stage 2 with these
    variables, both within 1.2e-6 of it); every other pixel holds ATOL."""
    args = _args(tmp_path)
    inputs = te.build_inputs(args)
    got = te.run_model(variables, inputs, args)
    want = {k: np.asarray(v)
            for k, v in jax_export.run_model(variables, inputs, args).items()}
    assert set(got) == set(want) and len(got) == 12
    for stage in ("stage1", "stage2", "stage3"):
        dense = got[f"{stage}.depth_dense"]
        for field in ("depth_dense", "confidence_dense"):
            k = f"{stage}.{field}"
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ATOL,
                                       err_msg=k)
        e = float(np.abs(dense - want[f"{stage}.depth_dense"]).max())
        flips = (got[f"{stage}.depth"] == 0) != (want[f"{stage}.depth"] == 0)
        if flips.any():
            edge = edge_kth_plain(torch.from_numpy(dense)).numpy()
            rank = discard_ranks(torch.tensor([args.discard_percentage]),
                                 edge[0].size)[0]
            thres = np.sort(edge.reshape(-1))[rank]
            assert np.all(np.abs(edge[flips] - thres) <= 4 * e), stage
        for field in ("depth", "confidence"):
            k = f"{stage}.{field}"
            np.testing.assert_allclose(got[k][~flips], want[k][~flips],
                                       rtol=0, atol=ATOL, err_msg=k)


def test_main_writes_the_unit(unit, variables):
    out, res = unit
    for name in ("sample_inputs.npz", "model_variables.pkl",
                 "model_config.json", "depth.png", "confidence.png",
                 te.PROGRAM, te.PROGRAM_INFO):
        assert (out / name).stat().st_size > 0, name
    assert res["exported_mae"] < GOLDEN_TOL
    assert res["golden_mae"] < GOLDEN_TOL
    assert te.verify_exported(str(out)) < GOLDEN_TOL
    pack = np.load(out / "sample_inputs.npz")
    assert sum(k.startswith("out.") for k in pack.files) == 12
    # The weights in the JAX format, exactly the input variables.
    back = jax_load_any(str(out / "model_variables.pkl"))
    flat = jax.tree_util.tree_flatten_with_path(variables)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf,
                                      err_msg=str(path))


def test_program_holds_the_custom_ops(unit):
    """One tandem::warp_sample node a source view and stage, one
    tandem::edge_filter (stage 3), and of floor, index and gather only the
    model's own: the two inter-stage upsamplings (2 floors and 6 indexings
    each) and the three depth heads' confidence gathers. The plain warp
    would add floors and indexings, the plain filter a sort."""
    program, _ = te.load_program(str(unit[0]))
    ops = collections.Counter(str(n.target) for n in program.graph.nodes
                              if n.op == "call_function")
    assert ops["tandem.warp_sample.default"] == 3 * (V - 1)
    assert ops["tandem.edge_filter.default"] == 1
    assert ops["aten.floor.default"] == 2 * 2
    assert ops["aten.index.Tensor"] == 2 * 6
    assert ops["aten.gather.default"] == 3
    assert not any("sort" in k or "bincount" in k for k in ops)


def _window(seed: int = 7):
    rng = np.random.RandomState(seed)
    bgrs = [rng.randint(0, 255, (H, W, 3)).astype(np.uint8)
            for _ in range(V)]
    poses = []
    for v in range(V):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.05 * v
        poses.append(T)
    K = np.array([[57.6, 0, 47.5], [0, 57.6, 31.5], [0, 0, 1]], np.float32)
    return bgrs, poses, K


def test_exported_runner_equals_the_program(unit):
    """The runner protocol on the program: the result of call_async and
    get_result equals a direct call of the program on the same packed
    inputs (the counterpart of tests/test_cli.py's StablehloRunner case)."""
    runner = ExportedRunner(str(unit[0]), H, W, view_num=V, device="cpu")
    bgrs, poses, K = _window()
    runner.call_async(bgrs, poses, K, 0.5, 6.0, discard_percentage=10.0)
    assert runner.device_ready()
    res = runner.get_result()
    image, Ks, c2w = runner.pack_inputs(bgrs, poses, K)
    program, _ = te.load_program(str(unit[0]))
    with torch.no_grad():
        ref = program.module()(
            torch.from_numpy(image).float() / 255.0,
            *(torch.from_numpy(k) for k in Ks), torch.from_numpy(c2w),
            torch.full((1,), 0.5), torch.full((1,), 6.0),
            torch.full((1,), 10.0))
    for key, want in zip(("depth", "confidence", "depth_dense",
                          "confidence_dense"), ref):
        np.testing.assert_array_equal(res[key], want[0].numpy(), key)
    assert (res["depth"] == 0).any() and (res["depth"] > 0).any()


def test_exported_runner_refuses_another_device_or_shape(unit):
    with pytest.raises(ValueError, match="exported for cpu"):
        ExportedRunner(str(unit[0]), H, W, view_num=V, device="cuda")
    with pytest.raises(ValueError, match="exported for"):
        ExportedRunner(str(unit[0]), H, W + 32, view_num=V, device="cpu")


def test_dataset_boots_a_weightless_unit(sequence, variables,  # noqa: F811
                                         tmp_path):
    """A unit with only model.pt2 (and its device record), the config and
    the pack, exported at the sequence's own size, boots tandem_dataset
    through ExportedRunner with the boot self-check."""
    work = tmp_path / "export"
    work.mkdir()
    with open(work / "in.pkl", "wb") as f:
        pickle.dump(variables, f)
    te.main(te.parser.parse_args(
        ["--ckpt", str(work / "in.pkl"), "--out-dir", str(work),
         "--width", str(SEQ_W), "--height", str(SEQ_H), "--view-num", "3",
         "--depth-num", DEPTH_NUM, "--device", "cpu"]))
    unit = tmp_path / "unit"
    unit.mkdir()
    for name in (te.PROGRAM, te.PROGRAM_INFO, "model_config.json",
                 "sample_inputs.npz"):
        shutil.copy(work / name, unit / name)
    out = tmp_path / "out"
    res = tandem_dataset.main(_argv(sequence, out, f"mvsnet_folder={unit}",
                                    "mesh_extraction_freq=2",
                                    "dr_mvsnet_view_num=3", "device=cpu"))
    _check_result(out, 22)
    assert isinstance(res["backend"].runner, ExportedRunner)
    assert res["backend"].call_num > 0
    assert (out / "mesh.obj").exists()


def _sweep(dtype, grad: bool):
    rng = np.random.RandomState(3)
    img = torch.tensor(rng.randn(2, 9, 11, 4).astype(np.float32),
                       dtype=dtype, requires_grad=grad)
    mat = torch.tensor([[[1.01, 0.0, 0.3, 0.1], [0.0, 0.99, -0.2, 0.0],
                         [0.0, 0.0, 1.0, 0.02]]] * 2)
    depth = torch.tensor(rng.rand(2, 3, 9, 11).astype(np.float32) + 0.5)
    return img, mat, depth


def _filter_args(conf: bool):
    rng = np.random.RandomState(4)
    depth = torch.tensor((rng.rand(2, 13, 17) * 3).astype(np.float32))
    return (depth, torch.tensor([10.0, 25.0]),
            torch.rand(2, 13, 17) if conf else None)


OPCHECK = {
    "warp_sample f32": lambda: (torch.ops.tandem.warp_sample,
                                (*_sweep(torch.float32, True), 0.001)),
    "warp_sample bf16": lambda: (torch.ops.tandem.warp_sample,
                                 (*_sweep(torch.bfloat16, True), 0.001)),
    "warp_sample_grad": lambda: (
        torch.ops.tandem.warp_sample_grad,
        (torch.randn(2, 3, 9, 11, 4), *_sweep(torch.float32, False)[1:],
         0.001)),
    "edge_filter": lambda: (torch.ops.tandem.edge_filter,
                            _filter_args(True)),
    "edge_filter without conf": lambda: (torch.ops.tandem.edge_filter,
                                         _filter_args(False)),
}


@pytest.mark.parametrize("case", OPCHECK)
def test_custom_ops_opcheck(case):
    """Schema, fake (meta) implementation, dispatch and, for warp_sample,
    the registered autograd formula on the CPU."""
    op, args = OPCHECK[case]()
    torch.library.opcheck(op, args)
