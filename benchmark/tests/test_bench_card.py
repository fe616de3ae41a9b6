"""On the card, at each cell's own size with a short window: the sound run
is correct, and each control (a layer in the precision below the
configuration's, in the program's place) and each fault are not.

    python -m pytest -p no:cacheprovider -m cuda benchmark/tests/test_bench_card.py
"""

import pytest
import torch

from benchmark.tests.drive import run_cell, scale_depth

pytestmark = pytest.mark.cuda
CELLS = ("mapping.abl04_640x480.kf_stream", "train.cva_default_640x480.b2")
MAP_CELLS = CELLS[:1]
SEED = 2 ** 32 + 2027


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run on the card")
    return "cuda"


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(card, cell):
    r = run_cell(cell, card, 640, 480, 5.0, SEED)
    assert r["correct"], r["checks"]


CONTROLS = [(CELLS[0], "mvsnet"), (CELLS[0], "tsdf"), (CELLS[1], "train")]


@pytest.mark.parametrize("cell,control", CONTROLS)
def test_control_is_not_correct(card, cell, control):
    r = run_cell(cell, card, 640, 480, 5.0, SEED, control=(control,))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", MAP_CELLS)
def test_altered_depth_is_not_correct(card, cell):
    r = run_cell(cell, card, 640, 480, 5.0, SEED, fault=scale_depth(1.03))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", MAP_CELLS)
def test_misplaced_fusion_is_not_correct(card, cell, monkeypatch):
    from benchmark.tests.drive import shift_fusion
    shift_fusion(monkeypatch, 0.01)
    r = run_cell(cell, card, 640, 480, 5.0, SEED)
    assert not r["correct"], r["checks"]


def test_half_batch_is_not_correct(card, monkeypatch):
    from tandem_tpu_torch.train import trainer
    to_device = trainer.batch_to_device
    monkeypatch.setattr(trainer, "batch_to_device", lambda b, d: trainer
                        .shard_batch(to_device(b, d), 0, 2))
    r = run_cell(CELLS[1], card, 640, 480, 5.0, SEED)
    assert not r["correct"], r["checks"]
