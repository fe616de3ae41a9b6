"""The port's training data path against the JAX package: the config
reader (no yaml on the card's machine), the nearest resize (no cv2 there),
the MVS dataset's batches, the batch iterator and the augmentation
functions. Exact unless a test states a tolerance."""

import glob
import os

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import yaml

from tandem_tpu import config as jcfg
from tandem_tpu.data import augment as jaug
from tandem_tpu.data.replica import MVSDataset as JMVSDataset
from tandem_tpu.data.replica import TruncatedDataset as JTruncatedDataset
from tandem_tpu.data.replica import make_batches as j_make_batches
from tandem_tpu_torch import config as pcfg
from tandem_tpu_torch.data import augment as paug
from tandem_tpu_torch.data.replica import (MVSDataset, NamedDataset,
                                           TruncatedDataset, make_batches,
                                           read_png, resize_nearest,
                                           write_png)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIGS = sorted(glob.glob(os.path.join(REPO, "tandem_tpu", "configs",
                                            "*.yaml")))
PORT_CONFIGS = sorted(glob.glob(os.path.join(REPO, "tandem_tpu_torch",
                                             "configs", "*.yaml")))
FIXTURES = {"replica_traj": os.path.join(REPO, "tests", "fixtures",
                                         "replica_traj"),
            "replica_mini": os.path.join(REPO, "tests", "fixtures",
                                         "replica_mini")}


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                       b.dtype)
    np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("path", JAX_CONFIGS + PORT_CONFIGS,
                         ids=lambda p: "/".join(p.split(os.sep)[-3:]))
def test_config_reader_equals_jax_load(path):
    """parse_yaml reads each config file as yaml.safe_load does, and load
    equals tandem_tpu.config.load (literal_eval, tuples) on it."""
    with open(path) as f:
        text = f.read()
    assert pcfg.parse_yaml(text) == yaml.safe_load(text)
    assert pcfg.load(path) == jcfg.load(path)


def test_config_merges_like_jax():
    """The port's defaults merged with every ablation file and a CLI tail
    equal the JAX package's, but for TRAIN.DEVICE (cuda in the port); the
    JAX package's own files merge into the port's defaults (TPU.* kept);
    unknown keys and odd tails raise."""
    tail = ["MODEL.DEPTH_NUM", "(8, 8, 4)", "TRAIN.LR", "1e-4",
            "DATA.ROOT_DIR", "some/dir", "AUG.ANY", "True",
            "IO.WEIGHTS_SUMMARY", "None", "TRAIN.DEVICE", "cpu"]
    for name in ("abl01_baseline", "abl02_vo_window",
                 "abl03_view_aggregation", "abl04_fewer_depth_planes"):
        j, p = jcfg.default(), pcfg.default()
        assert p.pop("TRAIN.DEVICE") == "cuda"
        assert j.pop("TRAIN.DEVICE") == "tpu"
        assert p == j
        j, p = jcfg.default(), pcfg.default()
        jcfg.merge_from_file(j, os.path.join(REPO, "tandem_tpu", "configs",
                                             f"{name}.yaml"))
        pcfg.merge_from_file(p, os.path.join(REPO, "tandem_tpu_torch",
                                             "configs", f"{name}.yaml"))
        jcfg.merge_from_list(j, tail)
        pcfg.merge_from_list(p, tail)
        assert p == j
    p = pcfg.default()
    pcfg.merge_from_file(p, JAX_CONFIGS[-1])     # the JAX default.yaml
    assert p["TPU.MESH_DATA"] == -1 and p["TRAIN.DEVICE"] == "tpu"
    with pytest.raises(KeyError):
        pcfg.merge_from_list(pcfg.default(), ["TRAIN.NOPE", "1"])
    with pytest.raises(ValueError):
        pcfg.merge_from_list(pcfg.default(), ["TRAIN.LR"])


def test_train_device(monkeypatch):
    """TRAIN.DEVICE: cpu is the CPU; cuda, mesh and multihost need a card
    (without one they raise, naming the CPU switch), but multihost
    under TANDEM_PLATFORM=cpu trains on the CPU; the multihost rendezvous
    comes from the JAX CLI's variables or torchrun's."""
    c = pcfg.default()
    monkeypatch.delenv("TANDEM_PLATFORM", raising=False)
    if not torch.cuda.is_available():
        for mode in ("cuda", "mesh", "multihost"):
            c["TRAIN.DEVICE"] = mode
            with pytest.raises(RuntimeError, match="TRAIN.DEVICE cpu"):
                pcfg.train_device(c)
    c["TRAIN.DEVICE"] = "cpu"
    assert pcfg.train_device(c) == torch.device("cpu")
    c["TRAIN.DEVICE"] = "multihost"
    monkeypatch.setenv("TANDEM_PLATFORM", "cpu")
    assert pcfg.train_device(c, rank=1) == torch.device("cpu")
    assert pcfg.rendezvous({"TANDEM_COORDINATOR": "10.0.0.1:1234",
                            "TANDEM_NUM_PROCESSES": "4",
                            "TANDEM_PROCESS_ID": "2"}) == \
        ("tcp://10.0.0.1:1234", 4, 2)
    assert pcfg.rendezvous({"MASTER_ADDR": "h", "MASTER_PORT": "29500",
                            "RANK": "1", "WORLD_SIZE": "2"}) == \
        ("tcp://h:29500", 2, 1)
    with pytest.raises(RuntimeError, match="TANDEM_COORDINATOR"):
        pcfg.rendezvous({})
    c["TRAIN.DEVICE"] = "tpu"
    with pytest.raises(ValueError):
        pcfg.train_device(c)


def test_nearest_resize_equals_cv2():
    """resize_nearest equals cv2.resize(INTER_NEAREST) over a grid of
    source and destination sizes (up and down, odd ratios), for uint8 RGB,
    uint16 and float32 images."""
    rng = np.random.RandomState(0)
    sizes = [1, 3, 7, 48, 60, 64, 96, 120, 128, 160, 192, 240, 256, 320,
             480, 512, 640, 641]
    for H in sizes[::3]:
        for W in sizes[1::3]:
            imgs = (rng.randint(0, 255, (H, W, 3), dtype=np.uint8),
                    rng.randint(0, 65535, (H, W), dtype=np.uint16),
                    rng.rand(H, W).astype(np.float32))
            for h in sizes[1::4]:
                for w in sizes[::4]:
                    for img in imgs:
                        want = cv2.resize(img, (w, h),
                                          interpolation=cv2.INTER_NEAREST)
                        np.testing.assert_array_equal(
                            resize_nearest(img, h, w), want,
                            err_msg=f"{img.dtype} {H}x{W} -> {h}x{w}")


@pytest.mark.parametrize("fixture,size", [
    ("replica_traj", None), ("replica_traj", (480, 640)),
    ("replica_mini", None), ("replica_mini", (480, 640))])
def test_mvs_dataset_equals_jax(fixture, size):
    """MVSDataset items equal the JAX package's (cv2.imread + cv2.resize)
    bit for bit: images, per-stage depths and masks, intrinsics, poses."""
    h, w = size if size else (None, None)
    kw = dict(height=h, width=w)
    j = JMVSDataset(FIXTURES[fixture], "val", **kw)
    p = MVSDataset(FIXTURES[fixture], "val", **kw)
    assert len(p) == len(j)
    for i in (0, len(j) - 1):
        _assert_tree_equal(p[i], j[i])


def test_batches_equal_jax():
    """make_batches gives the JAX package's batches in its order (the same
    numpy shuffle), serial and with threads; NamedDataset and
    TruncatedDataset keep their semantics."""
    kw = dict(height=48, width=64)
    j = JTruncatedDataset(length=7, front=True, dataset=JMVSDataset(
        FIXTURES["replica_traj"], "train", **kw))
    p = TruncatedDataset(length=7, front=True, dataset=MVSDataset(
        FIXTURES["replica_traj"], "train", **kw))
    assert (len(p), p.offset) == (len(j), j.offset) == (7, 8)
    want = list(j_make_batches(j, 2, shuffle=True, seed=7))
    for workers in (0, 3):
        got = list(make_batches(p, 2, shuffle=True, seed=7,
                                num_workers=workers))
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)
    assert len(list(make_batches(range(7), 2, drop_last=False))) == 4
    with pytest.raises(IndexError):
        p[7]
    assert NamedDataset(name="replica", dataset=p)[1]["dataset_name"] \
        == "replica"


def test_png_writer_round_trip(tmp_path):
    """write_png's files read back equal with cv2 and with read_png."""
    rng = np.random.RandomState(3)
    for img in (rng.randint(0, 65535, (17, 23), dtype=np.uint16),
                rng.randint(0, 255, (9, 11, 3), dtype=np.uint8),
                rng.randint(0, 255, (5, 4), dtype=np.uint8)):
        path = str(tmp_path / "x.png")
        write_png(path, img)
        np.testing.assert_array_equal(read_png(path), img)
        back = cv2.imread(path, -1)
        np.testing.assert_array_equal(back[..., ::-1] if img.ndim == 3
                                      else back, img)


def _jax_factors(key, cj=(0.05, 0.05, 0.05, 0.05), mb=(70.0, 0.5)):
    """The factors the JAX package's color_jitter / motion_blur_kernel
    draw from ``key`` (their own splits)."""
    kb, kc, ks, kh = jax.random.split(key, 4)
    b = 1.0 + jax.random.uniform(kb, (), minval=-cj[0], maxval=cj[0])
    c = 1.0 + jax.random.uniform(kc, (), minval=-cj[1], maxval=cj[1])
    s = 1.0 + jax.random.uniform(ks, (), minval=-cj[2], maxval=cj[2])
    h = jax.random.uniform(kh, (), minval=-cj[3], maxval=cj[3]) * 2 * jnp.pi
    ka, kd = jax.random.split(key)
    ang = jax.random.uniform(ka, (), minval=-mb[0], maxval=mb[0])
    dirn = jax.random.uniform(kd, (), minval=-mb[1], maxval=mb[1])
    return [torch.tensor(np.asarray(v)).reshape(1)
            for v in (b, c, s, h, ang, dirn)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augment_functions_equal_jax(seed):
    """Given the factors the JAX functions draw, the port's color jitter,
    hue shift, motion-blur kernel and blur compute theirs: 1e-6 absolute
    on images in [0, 1] (f32 sums in another order)."""
    rng = np.random.RandomState(seed)
    img = rng.rand(24, 32, 3).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    b, c, s, h, ang, dirn = _jax_factors(key)
    want = np.asarray(jaug.color_jitter(key, jnp.asarray(img)))
    got = paug.color_jitter(torch.tensor(img)[None], b, c, s, h)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        paug.hue_shift(torch.tensor(img), h.reshape(())).numpy(),
        np.asarray(jaug._rgb_to_hsv_hue_shift(jnp.asarray(img),
                                              jnp.asarray(h[0]))),
        rtol=0, atol=1e-6)
    for ksize in (11, 5):
        kj = np.asarray(jaug.motion_blur_kernel(key, ksize, 70.0, 0.5))
        kp = paug.motion_blur_kernel(ksize, ang, dirn)[0]
        np.testing.assert_allclose(kp.numpy(), kj, rtol=0, atol=1e-7)
        want = np.asarray(jaug.motion_blur(key, jnp.asarray(img), ksize,
                                           70.0, 0.5))
        got = paug.motion_blur(torch.tensor(img)[None], kp[None])[0]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_augment_batch_draws():
    """augment_batch: the same generator seed gives the same batch; other
    keys pass through; SAME_ON_VIEWS gives each tuple's views the same
    factors (so identical views stay identical); images stay in [0, 1]
    before the blur's zero padding pulls the border down."""
    rng = np.random.RandomState(4)
    view = rng.rand(1, 1, 3, 20, 24).astype(np.float32)
    image = torch.tensor(np.repeat(view, 3, axis=1).repeat(2, 0))
    batch = {"image": image, "depth": 5}
    a = paug.augment_batch(torch.Generator().manual_seed(9), batch)
    b = paug.augment_batch(torch.Generator().manual_seed(9), batch)
    assert torch.equal(a["image"], b["image"]) and a["depth"] == 5
    assert a["image"].shape == image.shape
    assert not torch.equal(a["image"][0, 0], a["image"][0, 1])
    same = paug.augment_batch(torch.Generator().manual_seed(9), batch,
                              same_on_views=True)["image"]
    assert torch.equal(same[0, 0], same[0, 2]) and torch.equal(same[1, 0],
                                                               same[1, 1])
    assert float(same.min()) >= 0 and float(same.max()) <= 1 + 1e-6
    assert paug.augment_batch(None, batch, any_aug=False) is batch


def test_camera_helpers_equal_jax():
    """cam_resize, cam_stack and stage_intrinsics_exact equal the JAX
    package's numpy helpers on the fixtures' cameras at three sizes."""
    from tandem_tpu.core import camera as jcam
    from tandem_tpu_torch.core import camera as pcam
    for fixture in FIXTURES.values():
        cam = MVSDataset(fixture, "val").scenes[0].cam_base
        for h, w in ((480, 640), (96, 128), (cam["height"], cam["width"])):
            _assert_tree_equal(pcam.cam_resize(cam, h, w),
                               jcam.cam_resize(cam, h, w))
            c = pcam.cam_resize(cam, h, w)
            _assert_tree_equal(pcam.cam_stack([c, c]), jcam.cam_stack([c, c]))
            for a, b in zip(pcam.stage_intrinsics_exact(c),
                            jcam.stage_intrinsics_exact(c)):
                _assert_tree_equal(a, b)
    with pytest.raises(ValueError):
        pcam.cam_stack([pcam.cam_resize(cam, 8, 8), cam])
