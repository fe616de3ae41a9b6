"""The plain references against the program on the CPU at a small size:
the CVA-MVSNet equal in float32 to rounding, the edge filter equal to the
program's plain filter, and the fp8 control far from it where the
program's bfloat16 path is near (what the limits separate); the TSDF
integrator equal to the program's fusion and its bfloat16 control not;
the trajectory errors by hand."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference.cva_mvsnet import (PlainCvaMVSNet, edge_filter,
                                            load_params)
from benchmark.traffic import common, scene

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "benchmark" / "configs" /
                     "abl04_640x480.json").read_text())
PATH = json.loads((ROOT / "benchmark" / "workloads" /
                   "kf_stream.json").read_text())["path"]
W, H = 160, 128


@pytest.fixture(scope="module")
def case():
    """A 7-view window of the path at 160 x 128 and its recorded call."""
    cam = scene.Camera(W, H, 375.0 * W / 640, 375.0 * W / 640)
    frames = [8 * j for j in range(7)]
    bgrs, _, depths = scene.render_frames(frames, PATH, cam,
                                          scene.texture_offset(5), "cpu")
    rec = {"bgrs": list(bgrs), "K": cam.K, "dmin": 0.01, "dmax": 10.0,
           "discard": 10.0,
           "c2w": [scene.path_pose(f, PATH).astype(np.float32)
                   for f in frames]}
    return rec, depths


def _program(dtype):
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
    model = CvaMVSNet(**CONFIG["model"], dtype=dtype)
    return MvsnetRunner(model, load_variables(
        str(ROOT / CONFIG["unit"] / "model_variables.pkl")), H, W, 7,
        device="cpu")


def _run_program(runner, rec):
    args = runner.pack_inputs(rec["bgrs"], rec["c2w"], rec["K"])
    return runner._run(*args, rec["dmin"], rec["dmax"], rec["discard"])


def _reference(quant="none"):
    return PlainCvaMVSNet(load_params(
        str(ROOT / CONFIG["unit"] / "model_variables.pkl"), "cpu"),
        CONFIG["model"], quant)


def test_reference_inputs_match_the_runner(case):
    rec, _ = case
    runner = _program(torch.float32)
    args = runner.pack_inputs(rec["bgrs"], rec["c2w"], rec["K"])
    mine = common.reference_inputs(rec, "cpu")
    dev = runner._device_inputs(*args, rec["dmin"], rec["dmax"],
                                rec["discard"])
    assert torch.equal(mine[0], dev[0])
    for a, b in zip(mine[1], dev[1:4]):
        assert torch.equal(a, b)
    assert torch.equal(mine[2], dev[4])


def test_float32_program_equals_the_reference(case):
    rec, depths = case
    out = _run_program(_program(torch.float32), rec)
    ref = _reference()(*common.reference_inputs(rec, "cpu"))
    gaps = common.mvs_gaps(out[0], out[1], ref[0], ref[1])
    assert gaps["depth_rel_gap"] < 1e-5
    # the confidence sums the four planes at the truncated expected index:
    # at the odd pixel a rounding-level change of that index moves the sum
    assert gaps["conf_gap"] < 1e-4
    assert gaps["mask_flip_share"] == 0.0
    # and the trained unit sees this scene: within 3% of the exact depth
    d, gt = ref[2][0], depths[5]
    ok = (d > 0) & (gt > 0)
    assert float(((d - gt).abs() / gt)[ok].median()) < 0.03


def test_control_is_far_where_bfloat16_is_near(case):
    rec, _ = case
    inputs = common.reference_inputs(rec, "cpu")
    ref = _reference()(*inputs)
    bf16 = common.mvs_gaps(*_run_program(_program(torch.bfloat16),
                                         rec)[:2], ref[0], ref[1])
    fp8 = common.mvs_gaps(*_reference("fp8")(*inputs)[:2], ref[0], ref[1])
    assert fp8["depth_rel_gap"] > 3 * bf16["depth_rel_gap"]
    assert fp8["mask_flip_share"] > 3 * bf16["mask_flip_share"]


def test_edge_filter_equals_the_programs_plain_filter():
    from tandem_tpu_torch.ops.edge_kth import discard_ranks, edge_filter_plain
    rng = np.random.default_rng(3)
    depth = torch.from_numpy(rng.uniform(1, 4, (2, 24, 32)).astype(
        np.float32))
    conf = torch.from_numpy(rng.uniform(0, 1, (2, 24, 32)).astype(np.float32))
    ranks = discard_ranks(torch.tensor([10.0, 10.0]), 24 * 32)
    want = edge_filter_plain(depth, ranks, conf)
    got = edge_filter(depth, conf, 10.0)
    assert torch.equal(got[0], want.depth) and torch.equal(got[1], want.conf)


def test_answer_sample_is_seeded_and_bounded():
    class Runner:
        def call_async(self, *a):
            pass

        def get_result(self, device=False):
            return {}

    class Map:
        def write(self, depth, c2w):
            pass

    class Backend:
        depth_map = Map()

    kept = []
    for seed in (1, 1, 2):
        s = common.AnswerSample(Runner(), Backend(), 4, seed)
        for k in range(40):
            s._admit(k, {"k": k})
        kept.append(sorted(s.kept))
    assert kept[0] == kept[1] and kept[0] != kept[2]
    assert all(len(k) == 4 for k in kept)


def _scans(case, n=3):
    """The path's depths at 160 x 128 as (depth, K, c2w) scans."""
    rec, depths = case
    K = torch.from_numpy(rec["K"])
    return [(depths[i], K, torch.from_numpy(rec["c2w"][i]))
            for i in range(n)]


def test_plain_tsdf_equals_the_programs_fusion(case):
    """The plain integrator over the same scans gives the program's volume
    (allocation, culled or full integration) to the bit; bfloat16
    storage, the control, does not."""
    from tandem_tpu_torch.mapping import tsdf as program
    from benchmark.reference.tsdf import PlainTsdf, volume_gap
    cfg = CONFIG["tsdf"]
    pcfg = program.TsdfConfig(**cfg)
    vol = program.create_volume(pcfg, "cpu")
    ref = PlainTsdf(cfg, "cpu")
    low = PlainTsdf(cfg, "cpu", torch.bfloat16)
    rgb = torch.zeros((H, W, 3))
    for i, (d, K, c2w) in enumerate(_scans(case)):
        vol = program.allocate_blocks(pcfg, vol, d, K, c2w)
        if i % 2:
            slots, n = program.visible_slots(pcfg, vol, K, c2w, H, W)
            vol = program.integrate_culled(pcfg, vol, d, rgb, K, c2w, slots,
                                           int(n))
        else:
            vol = program.integrate(pcfg, vol, d, rgb, K, c2w)
        ref.fuse(d, K, c2w)
        low.fuse(d, K, c2w)
    n = vol.n_allocated
    got = (vol.block_coords[:n], vol.tsdf[:n], vol.weight[:n])
    args = (cfg["table_dim"], cfg["truncation"], cfg["max_weight"])
    assert n == ref.coords.shape[0] > 0
    assert volume_gap(got, ref.volume(), *args) == 0.0
    assert volume_gap(low.volume(), ref.volume(), *args) > 1e-4


def test_volume_gap_counts_a_missing_block():
    from benchmark.reference.tsdf import volume_gap
    coords = torch.tensor([[0, 0, 0], [1, 0, 0]], dtype=torch.int32)
    tsdf = torch.full((2, 8), 0.02)
    weight = torch.full((2, 8), 4.0)
    full = (coords, tsdf, weight)
    half = (coords[:1], tsdf[:1], weight[:1])
    # the second block's voxels read |0.02| / 0.04 + 4 / 64 each
    want = (0.5 + 4 / 64) / 2
    assert volume_gap(half, full, 160, 0.04, 64.0) == pytest.approx(want)
    assert volume_gap(full, full, 160, 0.04, 64.0) == 0.0


def test_trajectory_errors_of_a_scaled_copy_and_a_jitter():
    from benchmark.reference.trajectory import trajectory_errors
    gt = [scene.path_pose(i, PATH) for i in range(40)]
    # a copy at 0.3 times the scale in another world frame reads 0
    A = np.eye(4)
    A[:3, :3] = scene.rotation(0.4, -0.2, 0.1)
    A[:3, 3] = (1.0, -2.0, 0.5)
    est = []
    for p in gt:
        q = A @ p
        q[:3, 3] *= 0.3
        est.append(q)
    e = trajectory_errors(est, gt)
    assert e["rpe_mm"] < 1e-6 and e["rpe_deg"] < 1e-5 and e["ate_mm"] < 1e-6
    # a 0.1 deg turn of every other frame reads about 0.1 deg a pair
    jit = [p @ np.block([[scene.rotation(np.radians(0.1) * (i % 2), 0, 0),
                          np.zeros((3, 1))], [np.zeros((1, 3)), 1]])
           for i, p in enumerate(gt)]
    e = trajectory_errors(jit, gt)
    assert e["rpe_deg"] == pytest.approx(0.1, rel=1e-3)
    assert e["rpe_median_deg"] == pytest.approx(0.1, rel=1e-3)
