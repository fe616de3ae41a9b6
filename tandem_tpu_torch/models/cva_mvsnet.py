"""CVA-MVSNet: 3-stage cascaded plane-sweep MVS with adaptive view
aggregation, for inference.

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
pins cuDNN convolutions and CUDA matmuls to full f32 (no TF32) for the
whole process; the TF32 default would cost the f32 golden parity (the same
trap as the TPU's default matmul precision).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.warp import plane_sweep_warp, ref_pixel_to_world
from .cost_reg import CostRegNet, VolumeGate
from .edge_filter import depth_filter_edges
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
    """Full f32 for cuDNN convolutions and CUDA matmuls (process-wide)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class CvaMVSNet(nn.Module):
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

    @torch.no_grad()
    def forward(self, image, intrinsic_matrix: Sequence[torch.Tensor],
                cam_to_world, depth_min, depth_max,
                depth_filter_discard_percentage=None) -> Outputs:
        B, V, C, H, W = image.shape
        feats = self.feature_net(image.reshape(B * V, C, H, W).float())
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
                prev = outputs[STAGES[i - 1]][0]
                up = interpolate_bilinear(prev[..., None].float(), hs,
                                          ws)[..., 0]
                depth_samples = adaptive_depth_range(
                    depth=up,
                    interval=self.depth_interval_ratio[i] * base_interval,
                    depth_num=self.depth_num[i])
            gate = self.volume_gates[stage] if self.view_aggregation else None
            outputs[stage] = self._depth_prediction(
                features[stage], intrinsic_matrix[i], cam_to_world,
                depth_samples, self.cost_regularization_net[stage], gate)

        # Edge filtering runs AFTER all stages (cva_mvsnet.py:165-177).
        result = {}
        for stage in STAGES:
            depth, conf = outputs[stage]
            if depth_filter_discard_percentage is not None:
                fdepth, mask = depth_filter_edges(
                    depth, depth_filter_discard_percentage)
                fconf = torch.where(mask, torch.zeros_like(conf), conf)
                result[stage] = StageOutputs(fdepth, fconf, depth, conf)
            else:
                result[stage] = StageOutputs(depth, conf, depth, conf)
        return Outputs(**result)

    def _depth_prediction(self, features, K, cam_to_world, depth_in,
                          cost_reg: CostRegNet, gate: Optional[VolumeGate]):
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
        acc = sq_acc = None
        for v in range(1, V):
            warped, _ = plane_sweep_warp(
                features[:, v], depth_in, src_K=K,
                src_cam_to_world=cam_to_world[:, v], ref_K=K,
                ref_cam_to_world=ref_c2w, with_mask=False, ref_p2w=ref_p2w)
            warped = warped.to(self.dtype)
            if gate is not None:
                diff_sq = (warped - ref_volume) ** 2
                term = (gate(diff_sq)[..., None] + 1.0) * diff_sq
                acc = term if acc is None else acc + term
            else:
                acc = warped if acc is None else acc + warped
                sq = warped ** 2
                sq_acc = sq if sq_acc is None else sq_acc + sq
        if gate is not None:
            volume = acc / (V - 1.0)
        else:
            vol_sum = ref_volume + acc
            vol_sq_sum = ref_volume ** 2 + sq_acc
            volume = vol_sq_sum / V - (vol_sum / V) ** 2
        return self._depth_head(volume, depth_in, cost_reg)

    @staticmethod
    def _depth_head(volume, depth_in, cost_reg: CostRegNet):
        """Cost volume -> (depth, confidence) (module.py:1110-1133): 3D U-Net
        logits, softmax over D, expected depth, and the confidence as the
        sum of 4 adjacent plane probabilities at the expected index,
        truncated like the reference's ``.long()``."""
        D = depth_in.shape[1]
        logits = cost_reg(volume.permute(0, 4, 1, 2, 3).contiguous())
        prob = torch.softmax(logits.float(), dim=1)          # (B, D, H, W)
        depth = torch.sum(prob * depth_in.float(), dim=1)
        prob_pad = nn.functional.pad(prob, (0, 0, 0, 0, 1, 2))
        prob4 = (prob_pad[:, 0:D] + prob_pad[:, 1:D + 1]
                 + prob_pad[:, 2:D + 2] + prob_pad[:, 3:D + 3])
        steps = torch.arange(D, dtype=torch.float32, device=prob.device)
        idx_f = torch.sum(prob * steps[None, :, None, None], dim=1)
        idx = torch.clamp(idx_f.long(), 0, D - 1)
        conf = torch.gather(prob4, 1, idx[:, None])[:, 0]
        return depth, conf
