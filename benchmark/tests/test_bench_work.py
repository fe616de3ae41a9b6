"""The yardstick's counts at small shapes against hand counts and against
torch's own operation counter on the plain reference."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import work
from benchmark.reference.cva_mvsnet import PlainCvaMVSNet, load_params

ROOT = Path(__file__).resolve().parents[2]
CONFIG = json.loads((ROOT / "benchmark" / "configs" /
                     "abl04_640x480.json").read_text())


def test_bound_is_the_larger_of_bytes_and_operations():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 67e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e9, 67e12) == pytest.approx(1.0)


def test_sample_work_by_hand():
    # D=2, H=3, W=4, C=8 in bf16: features 3*4*8*2, planes 2*3*4*4,
    # the matrix 48, samples 2*3*4*8*2
    nbytes, ops = work.sample_work(2, 3, 4, 8, "bfloat16")
    assert nbytes == 192 + 96 + 48 + 384
    assert ops == 24 * (40 + 56)


def test_track_lm_work_by_hand():
    # B=2, N=10 points of which 7 valid, a 4x5 level, 3 evaluations
    nbytes, ops = work.track_lm_work(2, 10, 7, 4, 5, 3)
    assert nbytes == 128 + 16 + 170 + 240 + 164
    assert ops == 3 * 180 * 7 * 2


def test_stage_shapes():
    s = work.stage_shapes(CONFIG["model"], 480, 640)
    assert s == {"stage1": (48, 120, 160, 32), "stage2": (4, 240, 320, 16),
                 "stage3": (4, 480, 640, 8)}


def test_feature_net_by_hand():
    # b = 1 at 4 x 4: conv0 3->1 and 1->1 3x3 at 16 px, conv1 5x5 1->2 and
    # two 3x3 2->2 at 4 px, conv2 5x5 2->4 and two 3x3 4->4 at 1 px, the
    # 1x1 out (4->4 at 1), skip2 (2->4 at 4), out2 3x3 4->2 at 4, skip3
    # (1->4 at 16), out3 3x3 4->1 at 16
    macs = (16 * 27 + 16 * 9 + 4 * 50 + 2 * 4 * 36 + 200 + 2 * 144 + 16
            + 32 + 4 * 72 + 64 + 16 * 36)
    assert work.feature_net_ops(4, 4, 1) == 2 * macs


@pytest.mark.parametrize("depth_num", [(8, 4, 4), (8, 8, 4)])
def test_mvsnet_ops_match_torch_counter(depth_num):
    """At 64 x 32, V = 3: the count from the shapes equals torch's count of
    the reference's convolutions and gate contractions; torch also counts
    the reference's projection products (a 3 x 3 by 3 x HW product and
    three 4 x 4 products a source view and stage), which the count leaves
    to the sample's own yardstick."""
    cfg = dict(CONFIG["model"], depth_num=list(depth_num))
    params = load_params(str(ROOT / CONFIG["unit"] / "model_variables.pkl"),
                         "cpu")
    model = PlainCvaMVSNet(params, cfg)
    V, H, W = 3, 32, 64
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.random((1, V, 3, H, W), np.float32))
    K = torch.tensor([[40.0, 0, 31.5], [0, 40.0, 15.5], [0, 0, 1]])
    Ks = []
    for s in (0.25, 0.5, 1.0):
        k = K.clone()
        k[:2] *= s
        Ks.append(k[None])
    c2w = torch.eye(4).repeat(1, V, 1, 1)
    c2w[0, 1:, 0, 3] = torch.tensor([0.05, -0.05])
    with FlopCounterMode(display=False) as counter:
        model(image, Ks, c2w, torch.tensor([0.5]), torch.tensor([4.0]), 10.0)
    projection = sum((V - 1) * (2 * 9 * h * w + 3 * 128)
                     for _, h, w, _ in work.stage_shapes(cfg, H, W).values())
    assert counter.get_total_flops() == (work.mvsnet_ops(cfg, H, W, V)
                                         + projection)


def test_share_percent():
    assert work.share_percent([1.0, 1.0], [4.0, 4.0]) == 25.0
    assert work.share_percent([1.0], []) is None
