"""The keyframe map path as a whole: the port's MvsnetRunner + TandemBackend
against the JAX package's, on the same converted random weights.

A 96x128, V=7 synthetic window slides along a textured plane (the
render_plane recipe of tests/test_coarse_tracker.py). Three backend calls:
each call after the first fuses the previous keyframe and renders at the
next reference pose. Per call, the rendered depth agrees within 1e-3 m on
>= 99% of pixels (the MVSNet depths differ by ~1e-6 between the
frameworks, which can flip a rare band voxel) and the allocated block count
is equal.
"""

import numpy as np
import pytest
import torch

from tandem_tpu.mapping.tsdf import TsdfConfig as JTsdfConfig
from tandem_tpu.models.cva_mvsnet import CvaMVSNet as JCvaMVSNet
from tandem_tpu.pipeline.backend import TandemBackend as JTandemBackend
from tandem_tpu.pipeline.mvsnet_runner import MvsnetRunner as JMvsnetRunner
from tandem_tpu_torch.mapping.tsdf import TsdfConfig
from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
from tandem_tpu_torch.pipeline.backend import TandemBackend
from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner
from tests.test_coarse_tracker import CX, CY, FX, FY, H, W, render_plane
from tests.test_torch_mvsnet import random_variables

V = 7
DEPTH_NUM = (8, 4, 4)
TSDF = dict(voxel_size=0.02, table_dim=64, pool_size=4096, truncation=0.08,
            max_depth=8.0)


def _c2w(x):
    p = np.eye(4, dtype=np.float32)
    p[0, 3] = x
    p[1, 3] = 0.3 * x
    return p


def _windows(n_calls):
    """Window i holds frames i .. i+V-1 of a camera sliding along x."""
    frames = [_c2w(0.03 * i) for i in range(n_calls + V)]
    bgrs = []
    for pose in frames:
        img, _ = render_plane(pose.astype(np.float64))
        bgrs.append(np.stack([np.clip(img, 0, 255)] * 3, -1).astype(np.uint8))
    return [(bgrs[i:i + V], frames[i:i + V], frames[i + V - 1])
            for i in range(n_calls)]


def test_backend_slice_matches_jax():
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    jm = JCvaMVSNet(depth_num=DEPTH_NUM, view_aggregation=True)
    variables = random_variables(jm, H, W, V, seed=5)
    jb = JTandemBackend(JMvsnetRunner(jm, variables, H, W, view_num=V),
                        JTsdfConfig(**TSDF), K, H, W, mesh_extraction_freq=0)
    tm = CvaMVSNet(depth_num=DEPTH_NUM, view_aggregation=True)
    tb = TandemBackend(MvsnetRunner(tm, variables, H, W, view_num=V,
                                    device="cpu"),
                       TsdfConfig(**TSDF), K, H, W)

    for i, (bgrs, poses, next_ref) in enumerate(_windows(3)):
        for b in (jb, tb):
            b.call(bgrs, poses, 0.5, 6.0, next_ref)
        if i == 0:
            assert tb.get_tracking_depth_map() is None
            continue
        dj = np.asarray(jb.get_tracking_depth_map()["depth"])
        dt = tb.get_tracking_depth_map()["depth"].numpy()
        assert dt.shape == (H, W) and np.isfinite(dt).all()
        assert (dt > 0).mean() > 0.2
        close = np.abs(dt - dj) <= 1e-3
        assert close.mean() >= 0.99, (i, close.mean())
        assert tb.stats()["n_allocated"] == jb.stats()["n_allocated"] > 0
    assert tb.ready() and tb.call_num == 3


def test_runner_packing_and_protocol_match_jax():
    """Ref-first reorder (ref = V-2), BGR uint8 -> RGB uint8 (1, V, 3, H,
    W) and the naive stage intrinsics equal the JAX runner's packing, dtype
    included; the call-order asserts hold."""
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    bgrs, poses, _ = _windows(1)[0]
    bgrs = [b.copy() for b in bgrs]
    bgrs[V - 2][..., 0] = 7                     # make B differ from R
    jm = JCvaMVSNet(depth_num=DEPTH_NUM, view_aggregation=True)
    variables = random_variables(jm, H, W, V, seed=5)
    jr = JMvsnetRunner(jm, variables, H, W, view_num=V)
    tr = MvsnetRunner(CvaMVSNet(depth_num=DEPTH_NUM, view_aggregation=True),
                      variables, H, W, view_num=V, device="cpu")
    img_j, Ks_j, c2w_j = jr.pack_inputs(bgrs, poses, K)
    img_t, Ks_t, c2w_t = tr.pack_inputs(bgrs, poses, K)
    assert img_t.dtype == img_j.dtype == np.uint8
    np.testing.assert_array_equal(img_t, img_j)
    for a, b in zip(Ks_t, Ks_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(c2w_t, c2w_j)
    np.testing.assert_array_equal(c2w_t[0, 0], poses[V - 2])

    with pytest.raises(AssertionError):
        tr.get_result()
    tr.call_async(bgrs, poses, K, 0.5, 6.0)
    assert not tr.ready() and tr.device_ready()
    with pytest.raises(AssertionError):
        tr.call_async(bgrs, poses, K, 0.5, 6.0)
    res = tr.get_result()
    assert tr.ready()
    assert set(res) == {"depth", "confidence", "depth_dense",
                        "confidence_dense"}
    assert res["depth"].shape == (H, W) and np.isfinite(res["depth"]).all()


def _runner():
    jm = JCvaMVSNet(depth_num=DEPTH_NUM, view_aggregation=True)
    variables = random_variables(jm, H, W, V, seed=5)
    return MvsnetRunner(CvaMVSNet(depth_num=DEPTH_NUM, view_aggregation=True),
                        variables, H, W, view_num=V, device="cpu")


def test_runner_normalization_equals_numpy():
    """The runner's uint8 -> [0, 1] step (the same code runs on the card)
    equals numpy's ``u8.astype(np.float32) / 255.0`` for all 256 values,
    bit for bit."""
    u8 = np.arange(256, dtype=np.uint8)
    got = _runner().normalize(torch.from_numpy(u8)).numpy()
    want = u8.astype(np.float32) / 255.0
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_runner_uint8_upload_equals_float_path():
    """The runner's outputs equal the model run on numpy's float image
    (u8 / 255 on the host, the path the runner took before) followed by
    the edge filter, bit for bit."""
    from tandem_tpu_torch.models.edge_filter import filter_edges
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)
    bgrs, poses, _ = _windows(1)[0]
    runner = _runner()
    runner.call_async(bgrs, poses, K, 0.5, 6.0)
    got = runner.get_result()
    img, Ks, c2w = runner.pack_inputs(bgrs, poses, K)
    out = runner.model(torch.from_numpy(img.astype(np.float32) / 255.0),
                       [torch.from_numpy(k) for k in Ks],
                       torch.from_numpy(c2w), torch.full((1,), 0.5),
                       torch.full((1,), 6.0)).stage3
    filtered = filter_edges(out.depth, torch.full((1,), 10.0),
                            out.confidence)
    for key, want in (("depth", filtered.depth), ("confidence", filtered.conf),
                      ("depth_dense", out.depth), ("confidence_dense",
                                                   out.confidence)):
        np.testing.assert_array_equal(got[key], want[0].numpy())


def test_entry_points_default_to_the_card():
    """The port runs on the card unless the caller asks for the CPU (the
    CPU tests pass device="cpu")."""
    import inspect

    from tandem_tpu_torch.mapping.tsdf import create_volume
    for fn in (MvsnetRunner.__init__, create_volume):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default).type == "cuda", fn
