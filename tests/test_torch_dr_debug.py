"""The port's dr_debug_example CLI against the JAX package's, on the CPU:
the first 3 frames of tests/fixtures/replica_traj with their GT poses
(gt_tum.txt) and the fixture's depth scale.

- the printed frame lines: ``allocated`` equal (the allocators agree
  exactly below 16k new blocks a scan), ``rendered_valid`` within 0.01;
- the render PNGs (16-bit, depth / 10 m x 65535, one unit 1.5e-4 m), as
  the raycast's parity in test_torch_raycast.py: >= 99% of the hit masks
  agree, depth within 1e-3 m on >= 90% of the pixels both hit and within
  0.08 m (one truncation step) on all; the JAX package marches bf16
  tables, the port the float32 volume;
- the mesh's vertex count within 0.1% (the volumes differ by the JAX
  package's f16 packs, ~1e-5, which moves a few cells' sign tests). The
  JAX CLI's OBJ text is not written (its save_obj is replaced: 2.3M
  vertices take ~30 s to format); the port writes its mesh.obj.
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from tandem_tpu_torch.data.replica import read_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "replica_traj", "scene0")
N = 3


def _argv(out):
    return ["--rgb", os.path.join(FIXTURE, "images"),
            "--depth", os.path.join(FIXTURE, "depths"),
            "--calib", os.path.join(FIXTURE, "camera_dso.txt"),
            "--poses", os.path.join(FIXTURE, "gt_tum.txt"),
            "--out", str(out), "--depth-scale", "0.0002",
            "--limit", str(N)]


def _lines(text):
    return [ln for ln in text.splitlines()
            if ln.startswith(("frame ", "mesh: "))]


def _fields(line):
    return dict(kv.split("=") for kv in line.split(":")[1].split())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import contextlib
    import io

    from tandem_tpu.cli import dr_debug_example as jcli
    from tandem_tpu.mapping import mesh as jmesh
    from tandem_tpu_torch.cli import dr_debug_example as tcli
    root = tmp_path_factory.mktemp("dr_debug")
    out = {}
    n, save_obj = torch.get_num_threads(), jmesh.save_obj
    torch.set_num_threads(1)      # six pytest workers share the CPU
    jmesh.save_obj = lambda path, *mesh: None
    try:
        for side, cli, extra in (("jax", jcli, []),
                                 ("port", tcli, ["--device", "cpu"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = cli.main(cli.parser.parse_args(_argv(root / side)
                                                     + extra))
            out[side] = (root / side, _lines(buf.getvalue()), res)
    finally:
        torch.set_num_threads(n)
        jmesh.save_obj = save_obj
    return out


def test_printed_lines_match_jax(runs):
    (_, lj, _), (_, lt, res) = runs["jax"], runs["port"]
    assert len(lj) == len(lt) == N + 1
    for a, b in zip(lj[:N], lt[:N]):
        fa, fb = _fields(a), _fields(b)
        assert a.split(":")[0] == b.split(":")[0]
        assert fa["allocated"] == fb["allocated"]
        assert abs(float(fa["rendered_valid"])
                   - float(fb["rendered_valid"])) <= 0.01
        assert float(fb["rendered_valid"]) > 0.9
    vj, vt = (int(x.split()[1]) for x in (lj[-1], lt[-1]))
    assert abs(vt - vj) <= 1e-3 * vj, (vt, vj)
    assert res["vertices"] == vt and len(res["times"]) == N


def test_renders_match_jax(runs):
    (dj, _, _), (dt, _, res) = runs["jax"], runs["port"]
    unit = 10.0 / 65535
    for i in range(N):
        name = f"render_{i:04d}.png"
        a = cv2.imread(str(dj / name), -1).astype(np.float64) * unit
        b = read_png(dt / name).astype(np.float64) * unit
        assert a.shape == b.shape == (192, 256)
        # The PNG holds the returned render.
        np.testing.assert_array_equal(
            read_png(dt / name),
            (np.clip(res["renders"][i] / 10.0, 0, 1) * 65535
             ).astype(np.uint16))
        ha, hb = a > 0, b > 0
        assert (ha == hb).mean() >= 0.99
        both = ha & hb
        err = np.abs(a - b)[both]
        assert (err <= 1e-3).mean() >= 0.90, (err <= 1e-3).mean()
        assert err.max() <= 0.08
    assert os.path.getsize(dt / "mesh.obj") > 0


def test_renders_hold_the_gt_depth(runs):
    """The render bars of chip_smoke's dr_debug phase: the raycast hits
    > 0.8 of each frame's GT-depth pixels, median |error| < 2 voxels."""
    from tandem_tpu_torch.data.reader import RGBDReader
    _, _, res = runs["port"]
    reader = RGBDReader(os.path.join(FIXTURE, "images"),
                        depth_path=os.path.join(FIXTURE, "depths"),
                        depth_scale=2e-4)
    vs = res["cfg"].voxel_size
    for i, r in enumerate(res["renders"]):
        gt = reader.get_depth(i)
        gt_ok = gt > 0
        both = gt_ok & (r > 0)
        assert both.sum() / gt_ok.sum() > 0.8
        assert np.median(np.abs(r[both] - gt[both])) < 2 * vs
