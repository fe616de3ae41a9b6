"""CVA-MVSNet inference runner: the dr_mvsnet equivalent.

Port of ``MvsnetRunner`` ("mono" mode) from
``tandem_tpu/pipeline/mvsnet_runner.py``. The reference runs a TorchScript
trace on a worker thread and its own CUDA stream behind an async
CallAsync/GetResult protocol (tandem/libdr/dr_mvsnet/src/dr_mvsnet.cpp:
20-120,285-331). Here ``call_async`` enqueues the cascade and the edge
filter on a dedicated ``torch.cuda.Stream`` and records an event;
``device_ready`` polls it and ``get_result`` hands the outputs over to the
caller's stream. On the CPU the call runs synchronously.

Input packing parity (dr_mvsnet.cpp:180-250):
- views reordered ref-first: [ref, others in original order], ref = V - 2
- BGR uint8 -> RGB uint8 (1, V, 3, H, W) on the host by the host
  library's ``bgr_pack_u8`` (``native_bridge``), the JAX runner's
  layout; uploaded as uint8 and divided by 255 on the device
- per-stage intrinsics by naive 0.25x/0.5x scaling (core/camera.py)
- call-order protocol asserts (dr_mvsnet.cpp:100-107,315-318).

``ExportedRunner`` serves the same protocol from a unit's ``model.pt2``
(``cli/tandem_export``) without the weights or the model's code.
``MvsnetRunner(..., devices=[...])`` serves it from the view-sharded
forward (``parallel/view_shard.py``), the counterpart of the JAX runner's
``mesh=``; the edge filter then runs on the first device.

The runner serves the model in its own dtype (``CvaMVSNet(dtype=...)``:
float32, or bfloat16 as the JAX runtime deploys it); the depth and
confidence it hands on are float32 in both.

On the card (one device, no ``devices``) the runner serves the stage-3
forward and the edge filter by replaying a CUDA graph of them
(``GraphedStage3``): one graph launch in place of ~1,300 eager ones a
keyframe, the same kernels in the same order on the same inputs. The
wrappers' counts ``warp_sample.launches``, ``warp_variance.launches``,
``deconv_bn_relu_add.launches``, ``edge_filter.calls`` and
``edge_filter.launches`` count where the kernels launch: a capture
launches none and adds nothing, each replay adds what the capture
recorded.

Spans (``utils/timer.py``; the backend hands the runner its Timer):
``mvsnet_pack``, ``mvsnet_upload`` and ``mvsnet_dispatch`` (the enqueue of
the stage-3 forward and the edge filter: on the card the copies into the
graph's inputs, its replay and the copies of its outputs) on the host,
``mvsnet`` on the runner's stream around them, and ``mvsnet_result``.
Counters, on the card: ``mvsnet_graph_captures``, 1 a capture, and
``mvsnet_graph_replays``, 1 a call a graph served and 0 a call that ran
eagerly; ``warp_variance.launches``, the variance kernel's launches
in a call that launches it (3 stages x the source views); and
``deconv.launches``, the decoder-step kernel's launches in a call that
launches it (3 stages x 3 steps).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..core.camera import stage_intrinsics_runtime
from ..models import convert
from ..models.cva_mvsnet import CvaMVSNet, Stage3Forward
from ..models.edge_filter import filter_edges
from ..native_bridge import bgr_pack_u8
from ..ops.bilinear_sample import warp_sample, warp_variance
from ..ops.deconv3d import deconv_bn_relu_add
from ..ops.edge_kth import edge_filter
from ..utils.timer import Timer


class MvsnetRunner:
    """Fixed-shape CVA-MVSNet inference with async dispatch."""

    def __init__(self, model: CvaMVSNet, variables: dict, height: int,
                 width: int, view_num: int = 7, device="cuda",
                 devices=None):
        """:param variables: the JAX package's numpy parameter tree
        ({'params', 'batch_stats'}), e.g. ``models.convert.load_variables``
        of an exported unit.
        :param device: the card by default; ``"cpu"`` only when asked (the
            CPU tests). Without a card the default raises.
        :param devices: a list of devices, one view shard each (a device
            may repeat): the cascade runs view-sharded
            (``parallel.build_view_sharded_forward``) and ``devices[0]``
            is the runner's device in place of ``device``."""
        self._start(devices[0] if devices else device, height, width,
                    view_num)
        model.load_state_dict(convert.flax_to_state_dict(
            variables, view_aggregation=model.view_aggregation))
        self.model = model.to(self.device).eval()
        self.dtype = model.dtype
        if devices:
            from ..parallel import build_view_sharded_forward
            self._forward = _ShardedStage3(
                build_view_sharded_forward(self.model, devices))
        elif self.device.type == "cuda":
            self._forward = GraphedStage3(Stage3Forward(self.model))
        else:
            self._forward = Stage3Forward(self.model)

    def _start(self, device, height: int, width: int, view_num: int):
        """The protocol's state: the device, the shapes, the 255 divisor
        and the runner's own CUDA stream."""
        self.device = torch.device(device)
        self.height, self.width, self.view_num = height, width, view_num
        # A tensor, not a Python float: CUDA turns ``x / 255.0`` into a
        # multiply by the rounded reciprocal, ``x / tensor`` divides.
        self._u8_scale = torch.tensor(255.0, device=self.device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._event = None
        self._pending = None
        self._ready = True
        self.timer = Timer(enabled=False)

    # --- packing ---------------------------------------------------------
    @staticmethod
    def reorder_ref_first(items: Sequence, ref_index: int) -> list:
        return [items[ref_index]] + [x for i, x in enumerate(items)
                                     if i != ref_index]

    def pack_inputs(self, bgrs: Sequence[np.ndarray],
                    cam_to_worlds: Sequence[np.ndarray], K: np.ndarray,
                    ref_index: Optional[int] = None):
        """bgrs: V arrays (H, W, 3) uint8 BGR; cam_to_worlds: V (4, 4).
        Returns numpy (1, V, 3, H, W) uint8 RGB, 3 x (1, 3, 3) stage
        intrinsics and (1, V, 4, 4) poses, reference view first."""
        assert len(bgrs) == self.view_num
        ref_index = self.view_num - 2 if ref_index is None else ref_index
        bgrs = self.reorder_ref_first(list(bgrs), ref_index)
        poses = self.reorder_ref_first(list(cam_to_worlds), ref_index)
        image = bgr_pack_u8(bgrs)[None]   # HWC BGR -> CHW RGB, in C
        Ks = tuple(k[None] for k in
                   stage_intrinsics_runtime(np.asarray(K, np.float32)))
        c2w = np.stack(poses)[None].astype(np.float32)
        return image, Ks, c2w

    def normalize(self, image):
        """uint8 image tensor on the runner's device -> float32 / 255,
        equal to numpy's ``u8.astype(np.float32) / 255.0`` for all 256
        values."""
        return image.float() / self._u8_scale

    # --- async protocol --------------------------------------------------
    def ready(self) -> bool:
        return self._ready

    def device_ready(self) -> bool:
        """True when the pending call (if any) has finished on the device,
        i.e. get_result() would not block (the occupancy signal behind the
        reference's Ready(), dr_mvsnet.cpp:100-107)."""
        return self._event is None or self._event.query()

    def wait(self):
        """Synchronize the runner's own CUDA stream (the reference's
        Wait); on the CPU calls run synchronously."""
        if self._stream is not None:
            self._stream.synchronize()

    def _run(self, image, Ks, c2w, depth_min, depth_max, discard):
        """The stage-3 forward on the packed inputs: (filtered depth,
        filtered confidence, depth, confidence), each (1, H, W)."""
        variance_launches = warp_variance.launches
        deconv_launches = deconv_bn_relu_add.launches
        with torch.no_grad():
            with self.timer.span("mvsnet_upload"):
                inputs = self._device_inputs(image, Ks, c2w, depth_min,
                                             depth_max, discard)
            with self.timer.span("mvsnet_dispatch"):
                outputs = self._forward(*inputs)
        served = getattr(self._forward, "served", None)
        if served is not None:
            self.timer.count("mvsnet_graph_replays",
                             int(served != "eager"))
            if served == "capture":
                self.timer.count("mvsnet_graph_captures")
        if warp_variance.launches != variance_launches:
            self.timer.count("warp_variance.launches",
                             warp_variance.launches - variance_launches)
        if deconv_bn_relu_add.launches != deconv_launches:
            self.timer.count("deconv.launches",
                             deconv_bn_relu_add.launches - deconv_launches)
        return outputs

    def _device_inputs(self, image, Ks, c2w, depth_min, depth_max,
                       discard) -> tuple:
        """The eight inputs of the stage-3 forward: the packed arrays on the
        device, the image divided there, and the discard share a CPU
        tensor, so the threshold rank needs no device sync."""
        dev = self.device
        return (self.normalize(torch.from_numpy(image).to(dev)),
                *(torch.from_numpy(k).to(dev) for k in Ks),
                torch.from_numpy(c2w).to(dev),
                torch.full((1,), depth_min, device=dev),
                torch.full((1,), depth_max, device=dev),
                torch.full((1,), discard))

    def call_async(self, bgrs, cam_to_worlds, K, depth_min: float,
                   depth_max: float, discard_percentage: float = 10.0,
                   ref_index: Optional[int] = None):
        assert self._ready, "CallAsync called before previous GetResult"
        self._ready = False
        with self.timer.span("mvsnet_pack"):
            args = self.pack_inputs(bgrs, cam_to_worlds, K, ref_index)
        if self._stream is None:
            self._pending = self._run(*args, depth_min, depth_max,
                                      discard_percentage)
            return
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            with self.timer.device_span("mvsnet", self._stream):
                self._pending = self._run(*args, depth_min, depth_max,
                                          discard_percentage)
            self._event = torch.cuda.Event()
            self._event.record(self._stream)

    def get_result(self, device: bool = False):
        """Stage-3 depth/confidence (+ dense variants) of the pending call.
        With device=True the tensors stay on the device and are handed to
        the caller's current stream without a host sync; otherwise this
        blocks and returns numpy arrays."""
        assert not self._ready, "GetResult called before CallAsync"
        with self.timer.span("mvsnet_result"):
            tensors = self._pending
            if self._event is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(self._event)
                for x in tensors:
                    x.record_stream(cur)
            conv = (lambda x: x) if device else (lambda x: x.cpu().numpy())
            result = {k: conv(x[0]) for k, x in zip(
                ("depth", "confidence", "depth_dense", "confidence_dense"),
                tensors)}
        self._pending = None
        self._event = None
        self._ready = True
        return result


def graph_key(tensors: Sequence[torch.Tensor],
              discard_percentage: torch.Tensor) -> Optional[tuple]:
    """What a CUDA graph of the stage-3 forward depends on in its inputs:
    the seven device tensors' shapes and dtypes, and the discard
    percentage's host value (the edge filter turns it into ranks inside its
    packed argument block when the graph is captured). None for a
    percentage off the CPU: reading it would wait for the card."""
    if discard_percentage.device.type != "cpu":
        return None
    return (tuple((tuple(x.shape), x.dtype) for x in tensors),
            tuple(discard_percentage.tolist()))


class GraphedStage3:
    """``Stage3Forward``'s contract served by replaying CUDA graphs of it,
    one a ``graph_key``. A key's first call runs the eager forward, which
    warms up what a capture cannot do (cuDNN's plans, the kernel library's
    build, the cached constants, cuBLAS's workspace on the stream); its
    second captures a graph on the current stream and replays it, and
    every later call replays it. A call without a key runs eagerly.
    ``served`` says how the last call was served: ``"eager"``,
    ``"capture"`` (captured, then replayed) or ``"replay"``.

    Each call copies the seven device inputs into the graph's own and
    hands out copies of its outputs, so no tensor handed out is rewritten
    by a later replay."""

    def __init__(self, forward: Stage3Forward):
        self.forward = forward
        self._graphs: dict = {}     # key -> _CapturedForward, None: seen once
        self.served = None

    def __call__(self, image, K1, K2, K3, cam_to_world, depth_min,
                 depth_max, discard_percentage):
        tensors = (image, K1, K2, K3, cam_to_world, depth_min, depth_max)
        key = graph_key(tensors, discard_percentage)
        if key is None or key not in self._graphs:
            if key is not None:
                self._graphs[key] = None
            self.served = "eager"
            return self.forward(*tensors, discard_percentage)
        graph = self._graphs[key]
        self.served = "replay"
        if graph is None:
            graph = self._graphs[key] = _CapturedForward(
                self.forward, tensors, discard_percentage)
            self.served = "capture"
        return graph(tensors)


# The wrappers' counts that the stage-3 forward moves: (function, attribute)
_COUNTS = ((warp_sample, "launches"), (warp_variance, "launches"),
           (deconv_bn_relu_add, "launches"), (edge_filter, "launches"),
           (edge_filter, "calls"))


def _read_counts() -> list:
    return [getattr(fn, name) for fn, name in _COUNTS]


def _add_counts(deltas):
    for (fn, name), n in zip(_COUNTS, deltas):
        setattr(fn, name, getattr(fn, name) + n)


class _CapturedForward:
    """One CUDA graph of the stage-3 forward, captured on the current
    stream into a memory pool of its own, with its static inputs and
    outputs. The wrappers count the kernels a capture records; no kernel
    launches then, so the counts are taken back and added at each
    replay."""

    def __init__(self, forward, tensors, discard_percentage):
        stream = torch.cuda.current_stream(tensors[0].device)
        self.inputs = tuple(torch.empty_like(x) for x in tensors)
        self.graph = torch.cuda.CUDAGraph()
        before = _read_counts()
        # thread_local: another thread's CUDA calls (the tracker's) may go
        # on while this one captures the runner's stream
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            self.outputs = forward(*self.inputs, discard_percentage)
        self.launches = [b - a for a, b in zip(before, _read_counts())]
        _add_counts(-n for n in self.launches)

    def __call__(self, tensors) -> tuple:
        for static, x in zip(self.inputs, tensors):
            static.copy_(x)
        self.graph.replay()
        _add_counts(self.launches)
        return tuple(y.clone() for y in self.outputs)


class _ShardedStage3:
    """``Stage3Forward``'s contract from the view-sharded forward: the
    stage-3 pair, then the edge filter on the first device
    (tandem_tpu/pipeline/mvsnet_runner.py:297-301)."""

    def __init__(self, sharded):
        self.sharded = sharded

    def __call__(self, image, K1, K2, K3, cam_to_world, depth_min,
                 depth_max, discard_percentage):
        depth, conf = self.sharded(image, (K1, K2, K3), cam_to_world,
                                   depth_min, depth_max)
        filtered = filter_edges(depth, discard_percentage, conf)
        return filtered.depth, filtered.conf, depth, conf


class ExportedRunner(MvsnetRunner):
    """The ``MvsnetRunner`` protocol served from a unit's ``model.pt2``
    alone (the counterpart of the JAX package's ``StablehloRunner``): the
    weights are inside the program, so no variables pickle and no model
    code are read. The program is ``torch.export``'s, written by
    ``cli/tandem_export``; it serves on the device it was exported for
    (another raises) and at its shapes, which the runner checks against
    the deployment's (1, V, 3, H, W)."""

    def __init__(self, unit_dir: str, height: int, width: int,
                 view_num: int = 7, device=None, devices=None):
        """:param device: by default the device the program was exported
            for; another raises.
        :param devices: not served: an exported program has fixed shapes
            and runs whole on its one device, so it cannot be split into
            view shards (``MvsnetRunner(devices=...)`` serves the weights
            that way)."""
        if devices is not None:
            raise ValueError(
                "ExportedRunner serves one device: the exported program has "
                "fixed shapes and cannot be view-sharded; use "
                "MvsnetRunner(model, variables, ..., devices=[...])")
        from ..cli.tandem_export import load_program

        program, dev = load_program(unit_dir, device)
        placeholder = {n.name: n for n in program.graph.nodes
                       if n.op == "placeholder"}
        shape = tuple(placeholder[program.graph_signature.user_inputs[0]]
                      .meta["val"].shape)
        if shape != (1, view_num, 3, height, width):
            raise ValueError(f"{unit_dir}: the program was exported for "
                             f"{shape}, asked (1, {view_num}, 3, {height}, "
                             f"{width})")
        self._start(dev, height, width, view_num)
        self.model = None
        self.dtype = torch.float32
        self.program = self._forward = program.module()
