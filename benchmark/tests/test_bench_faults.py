"""A run with the timed path broken underneath comes out not correct, on
the CPU at a small size, once for each fault the cells can have: an answer
altered where it is produced (the MVSNet's depth), a step that returns its
state unchanged (fusion leaving the TSDF as it was; a training step that
leaves the weights as they were), fusion at a wrong pose, and half of the
batch left out (the training step's mean taken over the rest). The sound
runs beside them come out correct. The MVSNet runs in float32 here: the
limits are the card's bfloat16 readings at 640 x 480, and the CPU's
bfloat16 at this size reads above them (its convolutions round
otherwise)."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.tests.drive import run_cell, scale_depth, shift_fusion

ROOT = Path(__file__).resolve().parents[2]
W, H = 160, 128
SEED = 2 ** 31 + 77
MAPPING = "mapping.abl04_640x480.kf_stream"
SLAM = "slam.abl04_640x480.handheld"
TRAIN = "train.cva_default_640x480.b2"
SMALL_SCENE = {"frames": 20}
F32 = {"dtype": "float32"}
# A short keyframe cycle (3 keyframes), so set-up fuses it quickly.
SMALL_STREAM = {"path": dict(json.loads(
    (ROOT / "benchmark" / "workloads" / "kf_stream.json").read_text()
)["path"], period=24), "sample_calls": 3}


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def test_mapping_sound_run_is_correct():
    r = run_cell(MAPPING, "cpu", W, H, 2.0, SEED, SMALL_STREAM, config=F32)
    assert r["correct"], r["checks"]


def test_mapping_altered_depth_is_not_correct():
    r = run_cell(MAPPING, "cpu", W, H, 2.0, SEED, SMALL_STREAM,
                 fault=scale_depth(1.03), config=F32)
    assert not r["correct"], r["checks"]


def test_mapping_unchanged_map_is_not_correct(monkeypatch):
    from tandem_tpu_torch.pipeline import backend
    monkeypatch.setattr(backend, "integrate", lambda cfg, vol, *a: vol)
    monkeypatch.setattr(backend, "integrate_culled",
                        lambda cfg, vol, *a: vol)
    r = run_cell(MAPPING, "cpu", W, H, 2.0, SEED, SMALL_STREAM, config=F32)
    assert not r["correct"], r["checks"]


def test_mapping_misplaced_fusion_is_not_correct(monkeypatch):
    """Fusion at a pose 1 cm off: the fused volume departs from the plain
    integrator's over the same scans."""
    shift_fusion(monkeypatch, 0.01)
    r = run_cell(MAPPING, "cpu", W, H, 2.0, SEED, SMALL_STREAM, config=F32)
    assert not r["correct"], r["checks"]
    assert r["checks"]["tsdf_gap"] > _limits(MAPPING)["tsdf_gap"]


def test_slam_sound_run_is_correct():
    r = run_cell(SLAM, "cpu", W, H, 20.0, SEED, config=F32)
    assert r["correct"], r["checks"]


def test_slam_altered_depth_is_not_correct():
    r = run_cell(SLAM, "cpu", W, H, 20.0, SEED, fault=scale_depth(1.03),
                 config=F32)
    assert not r["correct"], r["checks"]


def test_slam_unchanged_map_is_not_correct(monkeypatch):
    from tandem_tpu_torch.pipeline import backend
    monkeypatch.setattr(backend, "integrate", lambda cfg, vol, *a: vol)
    monkeypatch.setattr(backend, "integrate_culled",
                        lambda cfg, vol, *a: vol)
    r = run_cell(SLAM, "cpu", W, H, 20.0, SEED, config=F32)
    assert not r["correct"], r["checks"]


def _limits(cell):
    return json.loads((ROOT / "benchmark" / "limits" /
                       f"{cell}.json").read_text())


def test_train_sound_run_is_correct():
    r = run_cell(TRAIN, "cpu", 128, 96, 1.0, SEED, SMALL_SCENE)
    assert r["correct"], r["checks"]


def test_train_unchanged_weights_are_not_correct(monkeypatch):
    """A step that leaves the weights unchanged reads 1 in the parameters'
    change."""
    from tandem_tpu_torch.train import trainer
    create = trainer.create_train_state

    def frozen(*a, **k):
        model, state = create(*a, **k)
        state.optimizer.step = lambda *a, **k: None
        return model, state
    monkeypatch.setattr(trainer, "create_train_state", frozen)
    r = run_cell(TRAIN, "cpu", 128, 96, 1.0, SEED, SMALL_SCENE)
    assert not r["correct"], r["checks"]
    assert r["checks"]["update_gap"] == pytest.approx(1.0)


def test_train_half_batch_is_not_correct(monkeypatch):
    from tandem_tpu_torch.train import trainer
    to_device = trainer.batch_to_device

    def half(batch, device):
        return trainer.shard_batch(to_device(batch, device), 0, 2)
    monkeypatch.setattr(trainer, "batch_to_device", half)
    r = run_cell(TRAIN, "cpu", 128, 96, 1.0, SEED, SMALL_SCENE)
    assert not r["correct"], r["checks"]
    assert r["checks"]["grad_gap"] > _limits(TRAIN)["grad_gap"]
