"""The fusion kernels' wrappers on the CPU (``integrate``, ``splat_zbuf``'s
full walk and ``_fill_holes`` in ``mapping/tsdf.py``): they run their plain
versions for CPU tensors and launch nothing, they check their inputs on
either device, and the backend's CPU route records that the kernels did not
fuse its keyframes. The benchmark's record of the fused scans
(``FusedScans``) still sees every scan through the backend module's
``integrate`` and ``integrate_culled``. The kernels themselves are held
against the plain versions on the card (``tests/test_torch_cuda.py``).
"""

from collections import deque

import numpy as np
import pytest
import torch

from benchmark.traffic.common import FusedScans, Patches
from tandem_tpu_torch.mapping import tsdf as tt
from tandem_tpu_torch.pipeline import backend as backend_module
from tandem_tpu_torch.pipeline.backend import TandemBackend
from tandem_tpu_torch.utils import timer as tm

H, W = 60, 80
KW = dict(voxel_size=0.02, table_dim=64, pool_size=4096, truncation=0.08,
          max_depth=8.0)
CFG = tt.TsdfConfig(**KW)
K = np.array([[70.0, 0, (W - 1) / 2], [0, 70.0, (H - 1) / 2], [0, 0, 1]],
             np.float32)
T_ = torch.from_numpy


def _pose(tx=0.0, ty=0.0, tz=0.0, deg=0.0):
    a = np.deg2rad(deg)
    p = np.eye(4, dtype=np.float32)
    p[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                 [-np.sin(a), 0, np.cos(a)]]
    p[:3, 3] = [tx, ty, tz]
    return p


def _curved():
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    return (2.0 + 0.5 * np.sin(u * 0.15) * np.cos(v * 0.12)).astype(
        np.float32)


def _color():
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    return np.stack([100 + 0.5 * u, 60 + v, 200 - u], -1).astype(np.float32)


@pytest.fixture
def fused():
    """A curved surface fused from two cameras by the plain integrator."""
    vol = tt.create_volume(CFG, "cpu")
    for p in (_pose(), _pose(0.15, -0.1, 0.3, 10.0)):
        tt.allocate_blocks(CFG, vol, T_(_curved()), T_(K), T_(p))
        tt.integrate_plain(CFG, vol, T_(_curved()), T_(_color()), T_(K),
                           T_(p))
    return vol


@pytest.fixture
def counts():
    """The wrappers' launch counts, put back after the test."""
    fns = (tt.integrate, tt.splat_zbuf, tt._fill_holes)
    saved = [fn.launches for fn in fns]
    for fn in fns:
        fn.launches = 0
    yield fns
    for fn, n in zip(fns, saved):
        fn.launches = n


@pytest.mark.parametrize("case", ["integrate", "splat", "fill",
                                  "fill_zbuf", "render"])
def test_wrappers_on_cpu_equal_the_plain_versions(fused, counts, case):
    """Each wrapper on CPU tensors gives its plain version's result bit for
    bit and launches nothing."""
    pose = T_(_pose(0.1, 0.05, 0.2, 20.0))
    if case == "integrate":
        got, want = tt.copy_volume(fused), tt.copy_volume(fused)
        args = (T_(_curved() + 0.01), T_(_color()), T_(K), pose)
        tt.integrate(CFG, got, *args)
        tt.integrate_plain(CFG, want, *args)
        for f in ("tsdf", "weight", "color"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert not torch.equal(got.weight, fused.weight)
    elif case == "splat":
        got = tt.splat_zbuf(CFG, fused, T_(K), pose, H, W)
        want = tt.splat_zbuf_plain(CFG, fused, T_(K), pose, H, W)
        assert torch.equal(got, want) and torch.isfinite(got).sum() > 100
    elif case in ("fill", "fill_zbuf"):
        zbuf = tt.splat_zbuf_plain(CFG, fused, T_(K), pose, H, W).reshape(
            H, W)
        finite = torch.where(torch.isfinite(zbuf), zbuf,
                             torch.zeros_like(zbuf))
        want = tt.fill_holes_plain(finite, 2)
        got = (tt._fill_holes(zbuf, 2, from_zbuf=True) if case == "fill_zbuf"
               else tt._fill_holes(finite, 2))
        assert torch.equal(got, want) and (want > 0).sum() > (finite > 0).sum()
    else:
        got = tt.render_depth_splat(CFG, fused, T_(K), pose, H, W)
        zbuf = tt.splat_zbuf_plain(CFG, fused, T_(K), pose, H, W).reshape(
            H, W)
        want = tt.fill_holes_plain(torch.where(
            torch.isfinite(zbuf), zbuf, torch.zeros_like(zbuf)), 2)
        assert torch.equal(got, want)
    assert [fn.launches for fn in counts] == [0, 0, 0]


def _bad_inputs(vol):
    """(wrapper call, what is wrong) for each kind of fault."""
    d, c, k, p = T_(_curved()), T_(_color()), T_(K), T_(_pose())
    strided = torch.zeros((W, H)).T
    return [
        (lambda: tt.integrate(CFG, vol, d.double(), c, k, p), "dtype"),
        (lambda: tt.integrate(CFG, vol, d, c[..., :2].contiguous(), k, p),
         "shape"),
        (lambda: tt.integrate(CFG, vol, strided, c, k, p), "strided"),
        (lambda: tt.integrate(CFG, vol, d, c, k.double(), p), "dtype"),
        (lambda: tt.integrate(CFG, vol, d, c, k, p[:3]), "shape"),
        (lambda: tt.splat_zbuf(CFG, vol, k, p.T, H, W), "strided"),
        (lambda: tt.splat_zbuf(CFG, vol, k[:2], p, H, W), "shape"),
        (lambda: tt._fill_holes(d.half()), "dtype"),
        (lambda: tt._fill_holes(d[None]), "shape"),
        (lambda: tt._fill_holes(strided), "strided"),
    ]


@pytest.mark.parametrize("i", range(10))
def test_wrappers_reject_bad_input(fused, i):
    call, fault = _bad_inputs(fused)[i]
    with pytest.raises(ValueError, match="strided" if fault == "strided"
                       else "want a contiguous"):
        call()


@pytest.mark.parametrize("field", ["tsdf", "color", "page_table"])
def test_wrappers_reject_a_bad_volume(fused, field):
    """A volume tensor of the wrong dtype or layout is refused before any
    kernel could index it."""
    bad = tt.copy_volume(fused)
    t = getattr(bad, field)
    setattr(bad, field, t.double() if field == "tsdf" else
            t[..., :2] if field == "color" else t[:-1])
    with pytest.raises(ValueError, match=field):
        tt.integrate(CFG, bad, T_(_curved()), T_(_color()), T_(K),
                     T_(_pose()))
    with pytest.raises(ValueError, match=field):
        tt.splat_zbuf(CFG, bad, T_(K), T_(_pose()), H, W)


class _DepthRunner:
    """A stand-in MVSNet runner on the CPU that hands back a depth map a
    call (the curved surface, pushed back a little more each call)."""
    view_num = 7
    device = "cpu"

    def __init__(self):
        self.calls = 0
        self.handed = []

    def call_async(self, bgrs, cam_to_worlds, K, depth_min, depth_max,
                   discard_percentage=10.0):
        self.calls += 1

    def get_result(self, device=False):
        depth = T_(_curved() + 0.01 * self.calls)
        self.handed.append(depth)
        return {"depth": depth, "confidence": None}

    def device_ready(self):
        return True


def _backend_calls(backend, n=4):
    img = np.full((H, W, 3), 90, np.uint8)
    for i in range(n):
        poses = [_pose(0.02 * i)] * 7
        backend.call([img] * 7, poses, 0.5, 6.0, _pose(0.02 * (i + 1)))


def test_cpu_backend_records_no_kernel_fusion(monkeypatch):
    """The CPU route samples ``fusion_kernels`` 0 once a fused keyframe,
    after the call's span, and reads its three counts a keyframe."""
    log = deque(maxlen=tm.LOG_ENTRIES)
    monkeypatch.setattr(tm, "LOG", log)
    backend = TandemBackend(_DepthRunner(), CFG, K, H, W,
                            mesh_extraction_freq=0, timer=tm.Timer())
    assert not backend.on_card
    _backend_calls(backend)
    samples = [e for e in log if isinstance(e, tm.Sample)]
    kernels = [s for s in samples if s.name == "fusion_kernels"]
    assert [s.value for s in kernels] == [0, 0, 0]
    calls = [s for s in log if isinstance(s, tm.Span)
             and s.name == "backend_call"]
    assert all(calls[i + 1].end_ns <= s.ns <= calls[i + 2].start_ns
               for i, s in enumerate(kernels[:-1]))
    reads = sum(s.value for s in samples if s.name == "fusion_host_reads")
    assert reads == 3 * len(kernels)
    assert backend.last_fuse["n_visible"] is not None


def test_fused_scans_see_every_scan_through_the_module_globals():
    """The benchmark's contract: ``integrate`` and ``integrate_culled`` are
    attributes of the backend module, and every scan the backend fuses goes
    through one of them, so ``FusedScans``' patches record each one (the
    depth the runner handed over, with its camera)."""
    assert callable(backend_module.integrate)
    assert callable(backend_module.integrate_culled)
    patches = Patches()
    scans = FusedScans(patches)
    try:
        runner = _DepthRunner()
        backend = TandemBackend(runner, CFG, K, H, W, mesh_extraction_freq=0)
        _backend_calls(backend)
    finally:
        patches.undo()
    assert backend_module.integrate is tt.integrate
    assert len(scans.scans) == 3
    for (depth, k, c2w), handed, i in zip(scans.scans, runner.handed,
                                          range(3)):
        assert depth is handed
        assert torch.equal(k, T_(K)) and torch.equal(c2w, T_(_pose(0.02 * i)))
