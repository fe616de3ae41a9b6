"""The port's tandem_train and tandem_eval CLIs, its checkpoint formats,
the eval fixture's reference numbers and (slow) its learning curve, on
the CPU.

The CLIs run on the card by default: here they are given ``TRAIN.DEVICE
cpu`` / ``--device cpu``, and without those they raise."""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from tandem_tpu_torch import config as pcfg
from tandem_tpu_torch.cli import tandem_eval, tandem_train
from tandem_tpu_torch.data.replica import MVSDataset, collate, read_png
from tandem_tpu_torch.models.convert import flax_to_state_dict, load_variables
from tandem_tpu_torch.train import trainer as pt
from tandem_tpu_torch.train.checkpoint import (latest_checkpoint, load_any,
                                               save_checkpoint)
from tests.test_eval_fixture import REF_ABS_REL, REF_ABS_REL_ABL04, TOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ = os.path.join(REPO, "tests", "fixtures", "replica_traj")
MINI = os.path.join(REPO, "tests", "fixtures", "replica_mini")
UNIT = os.path.join(REPO, "exported", "tandem_512x320")

SMALL = ["DATA.ROOT_DIR", TRAJ, "DATA.IMG_HEIGHT", "64", "DATA.IMG_WIDTH",
         "96", "MODEL.DEPTH_NUM", "(8, 8, 4)", "TRAIN.EPOCHS", "1",
         "TRAIN.BATCH_SIZE", "2", "TRAIN.NUM_WORKERS", "0"]


def test_train_cli_epoch_checkpoint_and_resume(tmp_path):
    """Two steps with augmentation and TensorBoard summaries (image, depth,
    confidence, warp), a checkpoint, then a resume from it with
    --pretrained: model, optimizer, schedule and step come back, and the
    next checkpoint is the step after."""
    out = tmp_path / "run"
    res = tandem_train.main(tandem_train.parser.parse_intermixed_args([
        str(out), *SMALL, "TRAIN.MAX_STEPS", "2", "TRAIN.DEVICE", "cpu",
        "IO.LOG_INTERVAL", "1", "AUG.ANY", "True",
        "IO.SUMMARIES", "('image', 'depth', 'confidence', 'warp')"]))
    assert res["steps"] == 2 and np.isfinite(res["losses"]).all()
    ckpts = os.listdir(out / "ckpt")
    assert ckpts == ["step_00000002"]
    assert os.listdir(out / "tb" / "train")
    assert latest_checkpoint(str(out / "ckpt")) == res["checkpoints"][0]

    out2 = tmp_path / "run2"
    res2 = tandem_train.main(tandem_train.parser.parse_intermixed_args([
        str(out2), "--pretrained", res["checkpoints"][0], *SMALL,
        "TRAIN.MAX_STEPS", "1", "TRAIN.DEVICE", "cpu"]))
    assert res2["steps"] == 1
    assert os.listdir(out2 / "ckpt") == ["step_00000003"]
    a = torch.load(os.path.join(res["checkpoints"][0], "checkpoint.pt"),
                   weights_only=True)
    b = torch.load(os.path.join(res2["checkpoints"][0], "checkpoint.pt"),
                   weights_only=True)
    assert b["scheduler"]["last_epoch"] == a["scheduler"]["last_epoch"] + 1
    assert b["optimizer"]["state"][0]["step"] == 3

    with pytest.raises(FileExistsError):
        tandem_train.main(tandem_train.parser.parse_intermixed_args(
            [str(out), *SMALL, "TRAIN.DEVICE", "cpu"]))


def test_train_cli_runs_on_the_card_by_default(tmp_path):
    """Without TRAIN.DEVICE the CLI trains on the card; with no card it
    raises (naming the CPU switch), and so does mesh (one rank a card)."""
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only box's refusal")
    with pytest.raises(RuntimeError, match="TRAIN.DEVICE cpu"):
        tandem_train.main(tandem_train.parser.parse_intermixed_args(
            [str(tmp_path / "a"), *SMALL]))
    with pytest.raises(RuntimeError, match="TRAIN.DEVICE mesh: no CUDA"):
        tandem_train.main(tandem_train.parser.parse_intermixed_args(
            [str(tmp_path / "b"), *SMALL, "TRAIN.DEVICE", "mesh"]))
    with pytest.raises(RuntimeError, match="--device cpu"):
        tandem_eval.main(tandem_eval.parser.parse_args(
            ["--ckpt", "x.pkl", "--data-root", MINI]))


def test_eval_cli_report(tmp_path):
    """tandem_eval on the CPU at 256x160 with the trained 512x320 unit:
    the reference-format report, the pickled errors (finite, the 11
    metrics of each stage) and a 16-bit depth strip."""
    ckpt = str(tmp_path / "trained.pkl")
    shutil.copy(os.path.join(UNIT, "model_variables.pkl"), ckpt)
    errors = tandem_eval.main(tandem_eval.parser.parse_args([
        "--ckpt", ckpt, "--data-root", MINI, "--width", "256", "--height",
        "160", "--limit", "1", "--depth-num", "48,4,4", "--device", "cpu"]))
    lines = open(ckpt + ".txt").read().splitlines()
    assert any(ln.startswith("Performance:") for ln in lines)
    assert any("Eigen et. al" in ln for ln in lines)
    with open(ckpt + ".pkl", "rb") as f:
        saved = pickle.load(f)
    assert saved == errors
    for stage in ("stage1", "stage2", "stage3"):
        assert len(saved[stage]) == 11
        assert np.isfinite(list(saved[stage].values())).all()
    strip = read_png(ckpt + ".png")
    assert strip.dtype == np.uint16 and strip.shape == (320, 256)


def test_checkpoint_formats(tmp_path):
    """load_any: the port's checkpoint directory (weights, or the whole
    state into a given one), the JAX package's model_variables.pkl, a
    reference state_dict with PL prefixes; an orbax directory raises."""
    config = pcfg.default()
    model, state = pt.create_train_state(config, torch.Generator()
                                         .manual_seed(0), 10)
    path = save_checkpoint(str(tmp_path / "ckpt"), state, step=5)
    sd = load_any(path)
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    _, other = pt.create_train_state(config, torch.Generator()
                                     .manual_seed(1), 10)
    other.step = 0
    assert load_any(path, other) is other and other.step == 0
    assert torch.equal(next(other.model.parameters()),
                       next(model.parameters()))

    pkl = os.path.join(UNIT, "model_variables.pkl")
    want = flax_to_state_dict(load_variables(pkl))
    got = load_any(pkl)
    assert set(got) == set(want)
    ref = tmp_path / "ref.ckpt"
    torch.save({"state_dict": {f"model.{k}": v for k, v in want.items()}},
               ref)
    assert all(torch.equal(v, want[k]) for k, v in load_any(str(ref))
               .items())
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        load_any(str(tmp_path / "orbax"))


@pytest.mark.slow
def test_trainer_overfits_fixture():
    """The port's counterpart of test_trainer_overfits_fixture, with its
    gates: 41 steps from the seeded initialization on tuples 0 and 7 of
    the trajectory fixture at 96x128, planes (8, 8, 4): finite losses, the
    last under 0.25 x the first, stage-1 abs_rel under 0.15, and the mean
    of the last 5 under 0.5 x the mean of the first 5."""
    config = pcfg.default()
    config.update({"MODEL.DEPTH_NUM": (8, 8, 4), "TRAIN.BATCH_SIZE": 2,
                   "DATA.IMG_HEIGHT": 96, "DATA.IMG_WIDTH": 128})
    ds = MVSDataset(TRAJ, "val", height=96, width=128)
    batch = pt.batch_to_device(collate([ds[0], ds[7]]), "cpu")
    model, state = pt.create_train_state(config, torch.Generator()
                                         .manual_seed(0), 200)
    step = pt.make_train_step(model, config)
    losses, absrel = [], []
    for _ in range(41):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        absrel.append(float(m["stage1/abs_rel"]))
    print("losses", losses[0], losses[-1], "abs_rel", absrel[-1])
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.25 * losses[0], (losses[0], losses[-1])
    assert absrel[-1] < 0.15, absrel[-1]
    assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5])


@pytest.mark.parametrize("depth_num,ref", [("48,32,8", REF_ABS_REL),
                                           ("48,4,4", REF_ABS_REL_ABL04)])
def test_eval_chain_on_fixture(tmp_path, depth_num, ref):
    """test_eval_fixture.py's chain on the port: the trained 512x320 unit
    on replica_mini tuple 0 at 512x320 reproduces the reference's stage
    abs_rel within 0.01 at both architectures."""
    ckpt = str(tmp_path / "trained.pkl")
    shutil.copy(os.path.join(UNIT, "model_variables.pkl"), ckpt)
    errors = tandem_eval.main(tandem_eval.parser.parse_args([
        "--ckpt", ckpt, "--data-root", MINI, "--width", "512", "--height",
        "320", "--limit", "1", "--depth-num", depth_num, "--device", "cpu"]))
    for stage, want in ref.items():
        assert abs(errors[stage]["abs_rel"] - want) < TOL, (stage, errors)
