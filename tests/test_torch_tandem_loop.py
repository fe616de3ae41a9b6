"""The full TANDEM loop on the port (VO + backend: depth -> TSDF ->
render -> dense tracking) and mesh extraction against the JAX package.

The loop runs on the CPU with a depth oracle in place of CVA-MVSNet (the
analytic plane depth of the reference view, as tests/test_tandem_loop.py's
OracleRunner): the orchestration is what is checked (the one-keyframe
lookahead, fusion, the render handed to the tracker, periodic mesh
extraction). ``extract_mesh`` is held against the JAX package on the same
fused volume: the same vertex multiset within 1e-5 m (both sample the
same voxels; the triangle assembly is the same numpy code) and equal
colours; ``save_obj`` writes the same bytes.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tandem_tpu.mapping import mesh as jmesh
from tandem_tpu.mapping import tsdf as jt
from tandem_tpu_torch.mapping import mesh as tmesh
from tandem_tpu_torch.mapping import tsdf as tt
from tandem_tpu_torch.pipeline.backend import TandemBackend
from tandem_tpu_torch.pipeline.full_system import (FullSystem,
                                                   FullSystemOptions)
from tests.test_coarse_tracker import CX, CY, FX, FY, H, W, render_plane
from tests.test_full_system import _align_sim3_translations, make_sequence

TSDF = dict(voxel_size=0.02, table_dim=64, pool_size=4096, truncation=0.08,
            max_depth=8.0)
K_MAT = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread in this module: the tier-1 run puts six pytest
    workers on the CPU, and torch's default of one thread per core in each
    makes them thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class OracleRunner:
    """MvsnetRunner's protocol with the analytic plane depth of the
    reference view (index view_num - 2), as CPU tensors."""
    view_num = 4
    device = torch.device("cpu")

    def __init__(self):
        self._pending = None
        self.calls = 0

    def ready(self):
        return self._pending is None

    def device_ready(self):
        return True

    def call_async(self, bgrs, cam_to_worlds, K, depth_min, depth_max,
                   discard_percentage=10.0, ref_index=None):
        assert self._pending is None
        ref = self.view_num - 2 if ref_index is None else ref_index
        _, depth = render_plane(np.asarray(cam_to_worlds[ref], np.float64))
        d = torch.from_numpy(depth.astype(np.float32))
        self._pending = {"depth": d, "confidence": torch.ones_like(d),
                         "depth_dense": d, "confidence_dense":
                         torch.ones_like(d)}
        self.calls += 1

    def get_result(self, device: bool = False):
        res, self._pending = self._pending, None
        return res

    def wait(self):
        pass


def test_tandem_loop_port():
    poses_gt, images = make_sequence(n=22, step=0.02)
    meshes = []
    backend = TandemBackend(OracleRunner(), tt.TsdfConfig(**TSDF), K_MAT, H,
                            W, mesh_extraction_freq=2,
                            mesh_callback=lambda *m: meshes.append(m))
    opts = FullSystemOptions(selection_threshold_factor=0.35,
                             kf_global_weight=7.0, init_max_width=0.4,
                             mvs_view_num=4, max_keyframes=4,
                             num_point_slots=256, immature_cap=256)
    fs = FullSystem(FX, FY, CX, CY, H, W, options=opts, backend=backend,
                    device="cpu")
    live = 0
    for i, img in enumerate(images):
        bgr = np.stack([img] * 3, -1).astype(np.uint8)
        fs.add_active_frame(img, i, float(i) * 0.1, bgr=bgr)
        assert not fs.is_lost
        m = backend.get_tracking_depth_map()
        live += int(m is not None and bool(m["valid"]))
    assert fs.initialized and backend.call_num >= 2
    assert live > 0, "the tracking map never went live"
    # The render is metrically consistent with the oracle's plane at z=2
    # and reached the tracker as a dense reference.
    d = backend.get_tracking_depth_map()["depth"]
    hit = d > 0
    assert hit.float().mean() > 0.3
    assert 1.0 < float(d[hit].median()) < 3.0
    assert fs.tracker_ref.pvalid[0].sum() > 200
    # tests/test_tandem_loop.py's bound on the same loop.
    err = _align_sim3_translations([p[:3, 3] for p in fs.all_poses],
                                   [p[:3, 3] for p in poses_gt])
    assert err < 0.04, err
    assert meshes, "no periodic mesh"
    verts, faces, cols = backend.extract_mesh_now()
    assert len(verts) > 100 and len(faces) == len(verts) // 3
    assert np.isfinite(verts).all()


def _fused_jax_and_port():
    cfg_j, cfg_t = jt.TsdfConfig(**TSDF), tt.TsdfConfig(**TSDF)
    vol = jt.create_volume(cfg_j)
    for x in (0.0, 0.1):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3] = x
        img, depth = render_plane(c2w.astype(np.float64))
        color = np.stack([img, 0.5 * img, 255 - img], -1).astype(np.float32)
        args = (jnp.asarray(depth.astype(np.float32)), jnp.asarray(K_MAT),
                jnp.asarray(c2w))
        vol = jt.allocate_blocks(cfg_j, vol, *args)
        vol = jt.integrate(cfg_j, vol, args[0], jnp.asarray(color), *args[1:])
    port = tt.TsdfVolume(**{
        f: torch.from_numpy(np.array(getattr(vol, f))) for f in (
            "page_table", "block_coords", "tsdf", "weight", "color")},
        n_allocated=int(vol.n_allocated))
    return cfg_j, vol, cfg_t, port


def _sorted(v, c):
    order = np.lexsort(v.T[::-1])
    return v[order], c[order]


def test_extract_mesh_matches_jax(tmp_path):
    cfg_j, jvol, cfg_t, tvol = _fused_jax_and_port()
    jv, jf, jc = jmesh.extract_mesh(cfg_j, jvol)
    tv, tf, tc = tmesh.extract_mesh(cfg_t, tvol, chunk=200)
    assert len(jv) > 1000 and tv.shape == jv.shape
    assert np.array_equal(tf, jf)
    sv, sc = _sorted(tv, tc)
    rv, rc = _sorted(jv, jc)
    assert np.abs(sv - rv).max() < 1e-5
    assert np.array_equal(sc, rc)
    # The same bytes from both writers on the same mesh.
    jmesh.save_obj(str(tmp_path / "j.obj"), jv[:300], jf[:100], jc[:300])
    tmesh.save_obj(str(tmp_path / "t.obj"), jv[:300], jf[:100], jc[:300])
    assert (tmp_path / "j.obj").read_bytes() == (tmp_path / "t.obj"
                                                 ).read_bytes()
