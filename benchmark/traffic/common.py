"""What the SLAM and mapping drivers share: building the program under test
from a configuration, recording a seeded sample of the map path's answers
and every scan it fuses, and judging them against the plain references and
the scene's ground truth.
"""

from __future__ import annotations

import random
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference.cva_mvsnet import PlainCvaMVSNet, load_params
from ..reference.tsdf import PlainTsdf, volume_gap
from . import scene

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def camera(config: dict) -> scene.Camera:
    im = config["image"]
    return scene.Camera(im["width"], im["height"], im["fx"], im["fy"])


def unit_path(root: Path, config: dict, name: str) -> Path:
    return root / config["unit"] / name


class Patches:
    """Attributes replaced for a run, put back by ``undo``."""

    def __init__(self):
        self.saved = []

    def set(self, owner, attr: str, value):
        self.saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    def undo(self):
        while self.saved:
            owner, attr, value = self.saved.pop()
            setattr(owner, attr, value)


def build_map_path(root: Path, config: dict, device, patches: "Patches",
                   timer=None, control: Optional[dict] = None):
    """The program's runner and backend, as ``tandem_dataset`` builds them
    for a unit: the MVSNet in the configuration's dtype, the TSDF the
    configuration states, no mesh extraction; and the record of the scans
    the backend fuses (``FusedScans``, installed through ``patches``).
    With the ``mvsnet`` control (a ``PlainCvaMVSNet`` quant) the plain
    reference in that precision serves the runner's calls in the
    program's place."""
    from tandem_tpu_torch.mapping.tsdf import TsdfConfig
    from tandem_tpu_torch.models.convert import load_variables
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    from tandem_tpu_torch.pipeline.backend import TandemBackend
    from tandem_tpu_torch.pipeline.mvsnet_runner import MvsnetRunner

    cam = camera(config)
    model = CvaMVSNet(**config["model"], dtype=DTYPES[config["dtype"]])
    runner = MvsnetRunner(
        model, load_variables(str(unit_path(root, config,
                                            "model_variables.pkl"))),
        cam.height, cam.width, view_num=config["views"], device=device)
    if control and "mvsnet" in control:
        runner._forward = ReferenceForward(
            reference_model(root, config, device, control["mvsnet"]))
    backend = TandemBackend(runner, TsdfConfig(**config["tsdf"]), cam.K,
                            cam.height, cam.width, mesh_extraction_freq=0,
                            timer=timer)
    return runner, backend, FusedScans(patches)


class FusedScans:
    """Every scan the backend fuses, as it hands it to the integration:
    (depth, K, camera-to-world) device tensors, held by reference."""

    def __init__(self, patches: Patches):
        from tandem_tpu_torch.pipeline import backend as module
        self.scans: List[tuple] = []
        for name in ("integrate", "integrate_culled"):
            patches.set(module, name, self._recorded(getattr(module, name)))

    def _recorded(self, integrate):
        def recorded(cfg, vol, depth, color, K, cam_to_world, *rest):
            self.scans.append((depth, K, cam_to_world))
            return integrate(cfg, vol, depth, color, K, cam_to_world, *rest)
        return recorded


def program_volume(backend):
    """The backend's fused volume: (block coords, tsdf, weight) of its
    allocated blocks."""
    vol = backend.volume
    n = vol.n_allocated
    return vol.block_coords[:n], vol.tsdf[:n], vol.weight[:n]


def judge_fusion(config: dict, scans: FusedScans, got, device,
                 control: Optional[dict] = None) -> Dict[str, float]:
    """``tsdf_gap``: the program's fused volume against the plain
    integrator's over the same scans (``volume_gap``). With the ``tsdf``
    control, the plain integrator keeping its volume in that dtype takes
    the program's place."""
    cfg = config["tsdf"]
    ref = PlainTsdf(cfg, device)
    low = (PlainTsdf(cfg, device, DTYPES[control["tsdf"]])
           if control and "tsdf" in control else None)
    for scan in scans.scans:
        ref.fuse(*scan)
        if low is not None:
            low.fuse(*scan)
    if low is not None:
        got = low.volume()
    return {"tsdf_gap": volume_gap(got, ref.volume(), cfg["table_dim"],
                                   cfg["truncation"], cfg["max_weight"])}


class ReferenceForward:
    """A plain reference with the runner's forward contract: the eight
    stage-3 inputs -> (filtered depth, filtered confidence, depth,
    confidence)."""

    def __init__(self, model: PlainCvaMVSNet):
        self.model = model

    def __call__(self, image, K1, K2, K3, cam_to_world, depth_min,
                 depth_max, discard_percentage):
        return self.model(image, (K1, K2, K3), cam_to_world, depth_min,
                          depth_max, float(discard_percentage[0]))


def reference_model(root: Path, config: dict, device, quant: str = "none"):
    return PlainCvaMVSNet(
        load_params(str(unit_path(root, config, "model_variables.pkl")),
                    device), config["model"], quant)


class AnswerSample:
    """A seeded uniform sample (reservoir of ``size``) of the backend calls
    made while ``on``: each keeps its inputs, the MVSNet's filtered depth
    and confidence (fetched by the backend one call later) and the depth
    map that the next call renders for the tracker from the map holding
    this call's depth, with the frame id of the pose it is rendered at
    (``frame_id``, which the driver sets before each call)."""

    def __init__(self, runner, backend, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)
        self.on = False
        self.seen = 0
        self.kept: Dict[int, dict] = {}
        self.calls = 0
        self.frame_id = None
        self._pending: Optional[int] = None
        self._wrap(runner, backend)

    def _wrap(self, runner, backend):
        call_async, get_result = runner.call_async, runner.get_result
        write = backend.depth_map.write

        def on_call(bgrs, c2ws, K, dmin, dmax, discard=10.0, ref_index=None):
            k = self.calls
            self.calls += 1
            if self.on:
                self._admit(k, {"bgrs": list(bgrs),
                                "c2w": [np.array(c, np.float32)
                                        for c in c2ws],
                                "K": np.array(K, np.float32),
                                "dmin": float(dmin), "dmax": float(dmax),
                                "discard": float(discard),
                                "frame_id": self.frame_id})
            self._pending = k
            return call_async(bgrs, c2ws, K, dmin, dmax, discard, ref_index)

        def on_result(device: bool = False):
            res = get_result(device=device)
            rec = self.kept.get(self._pending)
            if rec is not None:
                rec["depth"] = res["depth"]
                rec["conf"] = res["confidence"]
            return res

        def on_write(depth, c2w):
            # During call m the backend renders, at call m's keyframe pose,
            # the map that holds call m - 1's depth.
            rec = self.kept.get(self.calls - 1)
            if rec is not None:
                rec["render"] = (depth, self.frame_id)
            return write(depth, c2w)

        runner.call_async, runner.get_result = on_call, on_result
        backend.depth_map.write = on_write

    def _admit(self, k: int, rec: dict):
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept[k] = rec
            return
        j = self.rng.randrange(self.seen)
        if j < self.size:
            victim = sorted(self.kept)[j]
            del self.kept[victim]
            self.kept[k] = rec

    def finish(self, runner):
        """Fetch the last call's answer (the backend takes it one call
        later)."""
        if not runner.ready():
            runner.get_result(device=True)


def _uint8_views(bgrs, ref_index: int, device):
    """(1, V, 3, H, W) RGB in [0, 1], reference view first: u8 / 255 in
    float32, divided on the host (a CUDA division by a Python number is a
    product with its rounded reciprocal)."""
    order = [ref_index] + [i for i in range(len(bgrs)) if i != ref_index]
    rgb = np.stack([bgrs[i][..., ::-1] for i in order]).astype(np.float32)
    rgb /= np.float32(255.0)
    return torch.from_numpy(rgb.transpose(0, 3, 1, 2).copy())[None].to(
        device)


def reference_inputs(rec: dict, device):
    """The reference's inputs from a call's recorded arguments: the views
    reordered reference first (the second newest, as the runtime does),
    the stage intrinsics by the runtime's 1/4 and 1/2 scaling."""
    V = len(rec["bgrs"])
    ref = V - 2
    image = _uint8_views(rec["bgrs"], ref, device)
    order = [ref] + [i for i in range(V) if i != ref]
    c2w = torch.from_numpy(np.stack([rec["c2w"][i] for i in order]))[None]
    Ks = []
    for s in (0.25, 0.5, 1.0):
        K = rec["K"].copy()
        K[:2] *= s
        Ks.append(torch.from_numpy(K)[None].to(device))
    dmin = torch.tensor([rec["dmin"]], device=device)
    dmax = torch.tensor([rec["dmax"]], device=device)
    return image, Ks, c2w.to(device), dmin, dmax, rec["discard"]


def mvs_gaps(depth, conf, ref_depth, ref_conf) -> dict:
    """The program's filtered depth and confidence against the reference's:
    the mean relative depth gap and the mean confidence gap over pixels
    both keep, and the share of pixels only one of them keeps."""
    d, c = depth.float().reshape(-1), conf.float().reshape(-1)
    rd, rc = ref_depth.float().reshape(-1), ref_conf.float().reshape(-1)
    both = (d > 0) & (rd > 0)
    n = max(int(both.sum()), 1)
    return {"depth_rel_gap": float(((d - rd).abs() / rd.clamp(min=1e-6))
                                   [both].sum()) / n,
            "conf_gap": float((c - rc).abs()[both].sum()) / n,
            "mask_flip_share": float(((d > 0) != (rd > 0)).float().mean())}


def judge_sample(root, config, sample: AnswerSample, device,
                 traffic) -> Dict[str, float]:
    """The worst of each MVSNet gap over the kept calls, and the share of
    the kept calls whose render for the tracker shows none of the scene.
    Run after the program's state is freed."""
    ref = reference_model(root, config, device)
    cam = camera(config)
    offset = scene.texture_offset(traffic["decor_seed"])
    worst: Dict[str, float] = {}
    renders = missing = 0
    for k in sorted(sample.kept):
        rec = sample.kept[k]
        if "depth" not in rec:
            continue
        out = ref(*reference_inputs(rec, device))
        for name, v in mvs_gaps(rec["depth"], rec["conf"], out[0],
                                out[1]).items():
            worst[name] = max(worst.get(name, 0.0), v)
        if "render" in rec:
            rdepth, fid = rec["render"]
            _, _, gt = scene.render(scene.path_pose(fid, traffic["path"]),
                                    cam, offset, device)
            renders += 1
            missing += int(((rdepth > 0) & (gt > 0)).sum()) == 0
    if renders:
        worst["render_missing"] = missing / renders
    return worst


def host_snapshot():
    """The machine's CPU time by kind (/proc/stat's first line, jiffies),
    this process's CPU seconds and the wall clock: what ``host_share``
    compares."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:]]
    except OSError:
        ticks = []
    return ticks, time.process_time(), time.perf_counter()


def host_share(a, b) -> str:
    """Over [a, b]: the share of the machine's CPU time that its hypervisor
    took (steal) and that was busy, and this process's CPU seconds over
    the wall seconds."""
    (ta, pa, wa), (tb, pb, wb) = a, b
    out = f"process cpu/wall {(pb - pa) / max(wb - wa, 1e-9):.3f}"
    if len(ta) >= 8 and len(tb) >= 8:
        d = [y - x for x, y in zip(ta, tb)]
        total = max(sum(d[:8]), 1)
        out += (f", machine busy {1 - (d[3] + d[4]) / total:.3f}, "
                f"steal {d[7] / total:.4f}")
    return out


def percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))
