"""CVA-MVSNet: 3-stage cascaded plane-sweep MVS with adaptive view
aggregation, for inference and training.

Port of ``tandem_tpu/models/cva_mvsnet.py`` (parity target
cva_mvsnet/models/cva_mvsnet.py:24-184 and module.py:1030-1139). The public
tensor contract is the JAX package's: image (B, V, C, H, W) RGB in [0, 1],
per-stage intrinsics (3 x (B, 3, 3)), cam_to_world (B, V, 4, 4) with the
reference view first, depth_min/depth_max (B,), optional
depth_filter_discard_percentage (B,). Module names follow the reference so
``models/convert.py``'s state_dict loads as is.

Precision: ``dtype`` float32 (the default) or bfloat16, the JAX package's
deployed dtype (cli/tandem_dataset.py:97-98), with the JAX cast points:
features, cost volume, gate and U-Net in ``dtype``; projections, depth
hypotheses, the upsampled depth, softmax and depth regression in float32;
every output float32. The bfloat16 model loads the same float32
state_dict and casts where the weights are used. Constructing the model
pins cuDNN convolutions and CUDA matmuls to full f32 (no TF32) and cuDNN
to deterministic algorithms for the whole process; the TF32 default would
cost the f32 golden parity (the same trap as the TPU's default matmul
precision).

Without view aggregation (CasMVSNet's cascade) the cost volume is the
variance of the V views' features. Inference adds each source view's
samples and their squares straight into its two running sums
(``ops/bilinear_sample.warp_variance``, one kernel a view on the card);
training keeps each view's (warped, warped^2) terms, which autograd needs.
Both sum in the same order and give the same volume.

``forward(..., train=True)`` is the JAX package's ``apply(..., train=True,
mutable=["batch_stats"])``: gradients flow (the eval path runs under
``torch.no_grad``), BatchNorm uses the batch's statistics and updates the
running ones in place (the gate's once a source view, in view order), and
gradients stop where the JAX package stops them: at the previous stage's
depth and at the confidence.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.warp import (plane_sweep_variance, plane_sweep_warp,
                        ref_pixel_to_world)
from .cost_reg import CostRegNet, VolumeGate
from .edge_filter import filter_edges
from .feature_net import FeatureNet
from .layers import interpolate_bilinear
from .ranges import adaptive_depth_range, uniform_depth_range

STAGES = ("stage1", "stage2", "stage3")


class StageOutputs(NamedTuple):
    depth: torch.Tensor
    confidence: torch.Tensor
    depth_dense: torch.Tensor
    confidence_dense: torch.Tensor


class Outputs(NamedTuple):
    stage1: StageOutputs
    stage2: StageOutputs
    stage3: StageOutputs


def pin_f32_precision():
    """Full f32 for cuDNN convolutions and CUDA matmuls, and cuDNN held to
    deterministic algorithms (process-wide): the same inputs give the same
    bits from run to run, which the edge filter's exact threshold needs."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


class CvaMVSNet(nn.Module):
    architecture = "cva_mvsnet"

    def __init__(self, depth_num: Tuple[int, ...] = (48, 32, 8),
                 depth_interval_ratio: Tuple[float, ...] = (1.0, 0.5, 0.25),
                 feature_net_base_channels: int = 8,
                 cost_volume_base_channels: Tuple[int, ...] = (8, 8, 8),
                 view_aggregation: bool = False, dtype=torch.float32):
        super().__init__()
        if len(depth_num) != 3 or depth_interval_ratio[0] != 1.0:
            raise ValueError("CvaMVSNet needs 3 stages and ratio[0] == 1")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"CvaMVSNet dtype {dtype}: float32 or bfloat16")
        pin_f32_precision()
        self.dtype = dtype
        self.depth_num = tuple(depth_num)
        self.depth_interval_ratio = tuple(depth_interval_ratio)
        self.view_aggregation = view_aggregation
        self.scale = {s: 2 ** (2 - i) for i, s in enumerate(STAGES)}
        self.feature_net = FeatureNet(feature_net_base_channels, dtype)
        fc = self.feature_net.out_channels
        self.cost_regularization_net = nn.ModuleDict({
            s: CostRegNet(fc[s], cost_volume_base_channels[i],
                          has_four_depths=self.depth_num[i] == 4,
                          dtype=dtype)
            for i, s in enumerate(STAGES)})
        if view_aggregation:
            self.volume_gates = nn.ModuleDict(
                {s: VolumeGate(fc[s], dtype) for s in STAGES})

    def forward(self, image, intrinsic_matrix: Sequence[torch.Tensor],
                cam_to_world, depth_min, depth_max,
                depth_filter_discard_percentage=None,
                train: bool = False) -> Outputs:
        """
        :param image: (B, V, C, H, W) RGB in [0, 1]
        :param intrinsic_matrix: 3 x (B, 3, 3), stage order
        :param cam_to_world: (B, V, 4, 4), reference view first
        :param depth_min, depth_max: (B,)
        :param depth_filter_discard_percentage: optional (B,) in [0, 100]
        :param train: training mode (see the module's docstring)
        """
        if train:
            return self._forward(image, intrinsic_matrix, cam_to_world,
                                 depth_min, depth_max,
                                 depth_filter_discard_percentage, True)
        with torch.no_grad():
            return self._forward(image, intrinsic_matrix, cam_to_world,
                                 depth_min, depth_max,
                                 depth_filter_discard_percentage, False)

    def _forward(self, image, intrinsic_matrix, cam_to_world, depth_min,
                 depth_max, depth_filter_discard_percentage, train: bool):
        B, V, C, H, W = image.shape
        feats = self.feature_net(image.reshape(B * V, C, H, W).float(),
                                 train)
        # per stage: (B, V, Hs, Ws, Cs), channels last and contiguous for
        # the warp's kernel
        features = {s: f.permute(0, 2, 3, 1).contiguous().reshape(
                        B, V, *f.shape[2:], f.shape[1])
                    for s, f in feats.items()}

        outputs = {}
        base_interval = None
        for i, stage in enumerate(STAGES):
            hs, ws = H // self.scale[stage], W // self.scale[stage]
            if i == 0:
                depth_samples, base_interval = uniform_depth_range(
                    depth_min=depth_min, depth_max=depth_max,
                    depth_num=self.depth_num[i], height=hs, width=ws)
            else:
                prev = outputs[STAGES[i - 1]][0].detach()
                up = interpolate_bilinear(prev[..., None].float(), hs,
                                          ws)[..., 0]
                depth_samples = adaptive_depth_range(
                    depth=up,
                    interval=self.depth_interval_ratio[i] * base_interval,
                    depth_num=self.depth_num[i])
            gate = self.volume_gates[stage] if self.view_aggregation else None
            outputs[stage] = self._depth_prediction(
                features[stage], intrinsic_matrix[i], cam_to_world,
                depth_samples, self.cost_regularization_net[stage], gate,
                train)

        return filtered_outputs(outputs, depth_filter_discard_percentage)

    def _depth_prediction(self, features, K, cam_to_world, depth_in,
                          cost_reg: CostRegNet, gate: Optional[VolumeGate],
                          train: bool = False):
        """One cascade stage (module.py:1030-1139 semantics).

        :param features: (B, V, H, W, C) stage features, ref view first
        :param K: (B, 3, 3), shared by all views (runtime contract)
        :param depth_in: (B, D, H, W)
        :return: depth (B, H, W), confidence (B, H, W)
        """
        B, V, H, W, C = features.shape
        ref_volume = features[:, 0, None].to(self.dtype)   # (B, 1, H, W, C)
        ref_c2w = cam_to_world[:, 0]
        # The reference's pixel -> world matrix once for all views (the
        # same ops on the same tensors: equal to computing it per view).
        ref_p2w = ref_pixel_to_world(K, ref_c2w)
        # Views are accumulated one at a time: a per-view (B, D, H, W, C)
        # volume is never stacked (118 MB each at stage 1, 640x480).
        acc = None
        if gate is None and not train:
            # The variance's sums, one sample kernel a view in place: no
            # view's warped volume or its square is held.
            for v in range(1, V):
                acc = plane_sweep_variance(
                    features[:, v], depth_in, acc, src_K=K,
                    src_cam_to_world=cam_to_world[:, v], ref_p2w=ref_p2w)
            volume = self._finalize_volume(acc, ref_volume, V, gated=False)
            return self._depth_head(volume, depth_in, cost_reg, train)
        for v in range(1, V):
            warped, _ = plane_sweep_warp(
                features[:, v], depth_in, src_K=K,
                src_cam_to_world=cam_to_world[:, v], ref_K=K,
                ref_cam_to_world=ref_c2w, with_mask=False, ref_p2w=ref_p2w)
            terms = self._view_contrib(warped, ref_volume, gate, train)
            acc = list(terms) if acc is None else [
                a + t for a, t in zip(acc, terms)]
        volume = self._finalize_volume(acc, ref_volume, V,
                                       gated=gate is not None)
        return self._depth_head(volume, depth_in, cost_reg, train)

    def _view_contrib(self, warped, ref_volume, gate: Optional[VolumeGate],
                      train: bool = False) -> Tuple[torch.Tensor, ...]:
        """One source view's cost-volume contribution (module.py:1060-1090):
        gated -> ((reweight + 1) * diff^2,); variance -> (warped,
        warped^2). The monolithic stage and the view-sharded forward
        (parallel/view_shard.py) share it."""
        warped = warped.to(self.dtype)
        if gate is not None:
            diff_sq = (warped - ref_volume) ** 2
            return (self._gate_term(diff_sq, gate, train),)
        return (warped, warped ** 2)

    @staticmethod
    def _gate_term(diff_sq, gate: VolumeGate, train: bool = False):
        """Adaptive view-aggregation reweighting of one view's diff^2
        volume: (reweight + 1) * diff^2 (module.py:1075-1082)."""
        return (gate(diff_sq, train)[..., None] + 1.0) * diff_sq

    @staticmethod
    def _finalize_volume(acc, ref_volume, V, gated: bool):
        """The summed per-view contributions -> the cost volume. ``V``
        counts all views, the reference's included (a number, or a
        summed count on the sharded path)."""
        if gated:
            return acc[0] / (V - 1.0)
        vol_sum = ref_volume + acc[0]
        vol_sq_sum = ref_volume ** 2 + acc[1]
        return vol_sq_sum / V - (vol_sum / V) ** 2

    @staticmethod
    def _depth_head(volume, depth_in, cost_reg: CostRegNet,
                    train: bool = False):
        """Cost volume -> (depth, confidence) (module.py:1110-1133): 3D U-Net
        logits, softmax over D, expected depth, and the confidence as the
        sum of 4 adjacent plane probabilities at the expected index,
        truncated like the reference's ``.long()``."""
        logits = cost_reg(volume.permute(0, 4, 1, 2, 3).contiguous(), train)
        return regress_depth(torch.softmax(logits.float(), dim=1), depth_in)


def regress_depth(prob, depth_in):
    """The plane probabilities (B, D, H, W) -> the expected depth and the
    confidence: the sum of 4 adjacent plane probabilities at the expected
    index, truncated like the reference's ``.long()`` (module.py:1110-1133).
    """
    D = depth_in.shape[1]
    depth = torch.sum(prob * depth_in.float(), dim=1)
    prob_pad = nn.functional.pad(prob, (0, 0, 0, 0, 1, 2))
    prob4 = (prob_pad[:, 0:D] + prob_pad[:, 1:D + 1]
             + prob_pad[:, 2:D + 2] + prob_pad[:, 3:D + 3])
    steps = torch.arange(D, dtype=torch.float32, device=prob.device)
    idx_f = torch.sum(prob * steps[None, :, None, None], dim=1)
    idx = torch.clamp(idx_f.long(), 0, D - 1)
    conf = torch.gather(prob4, 1, idx[:, None])[:, 0]
    return depth, conf.detach()


def filtered_outputs(outputs, discard_percentage) -> Outputs:
    """{stage: (depth, confidence)} -> ``Outputs``, each stage's pair
    edge-filtered where a percentage is given. The filter runs after all
    stages (cva_mvsnet.py:165-177)."""
    result = {}
    for stage in STAGES:
        depth, conf = outputs[stage]
        if discard_percentage is not None:
            filtered = filter_edges(depth, discard_percentage, conf)
            result[stage] = StageOutputs(filtered.depth, filtered.conf,
                                         depth, conf)
        else:
            result[stage] = StageOutputs(depth, conf, depth, conf)
    return Outputs(**result)


class Stage3Forward(nn.Module):
    """The deployable forward: the JAX export's eight inputs (image,
    K1, K2, K3, cam_to_world, depth_min, depth_max, discard_percentage;
    tandem_tpu/cli/tandem_export.py:175-188) -> stage 3's filtered depth
    and confidence and the unfiltered pair. The filter runs on stage 3
    alone, as ``MvsnetRunner`` runs it (the model filters each stage the
    same way, so the outputs equal its stage-3 fields). No host read and no
    branch on a device: ``torch.export`` traces it whole, with the kernels
    as custom-op nodes."""

    def __init__(self, model: CvaMVSNet):
        super().__init__()
        self.model = model

    def forward(self, image, K1, K2, K3, cam_to_world, depth_min, depth_max,
                discard_percentage):
        out = self.model._forward(image, (K1, K2, K3), cam_to_world,
                                  depth_min, depth_max, None, False)
        depth, conf = out.stage3.depth, out.stage3.confidence
        filtered = filter_edges(depth, discard_percentage, conf)
        return filtered.depth, filtered.conf, depth, conf


def outputs_to_dict(outputs: Outputs):
    """{stage: {"depth", "confidence"}} of the (filtered) outputs."""
    return {s: {"depth": getattr(outputs, s).depth,
                "confidence": getattr(outputs, s).confidence}
            for s in STAGES}
