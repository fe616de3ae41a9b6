"""Plain CasMVSNet inference with the depth-edge filter: the benchmark's
reference for the map path of the cascade without view aggregation.

Written from the published model (Gu et al., "Cascade Cost Volume for
High-Resolution Multi-View Stereo and Stereo Matching", CVPR 2020,
arXiv:1912.06378, section 4; CasMVSNet/models/{cas_mvsnet,module}.py of
github.com/alibaba/cascade-stereo) in plain torch operations. The layers
(FeatureNet, the 3D U-Net, BatchNorm in its eval form), the plane sweep
(``grid_sample``, bilinear, zero padding, corners aligned), the depth
head and the edge filter are those of ``cva_mvsnet.py``, which TANDEM's
CVA-MVSNet took from CasMVSNet; what differs is the cost volume: the
variance of the V views' features, E[x^2] - E[x]^2, summed in CasMVSNet's
order (the reference view first, then each source view), with no gate.
It imports nothing of the program and no kernel.

Departures from CasMVSNet's published test, both TANDEM's runtime:
- the depth-edge filter runs on stage 3 (``cva_mvsnet.edge_filter``), as
  TANDEM's runtime does; CasMVSNet's test filters by photometric and
  geometric consistency after the network instead;
- the depth range is the caller's (TANDEM's ``_deliver_dr_frame`` rule
  in the map path), not DTU's fixed range from the camera files, and the
  later stages' hypotheses follow TANDEM's cascade (``cva_mvsnet``).

Precision: float32 with TF32 off. ``quant="tf32"`` is the control of the
float32 configuration: cuDNN and the matmuls in TF32.

Inputs: as ``PlainCvaMVSNet``'s (the runtime contract).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .cva_mvsnet import PlainCvaMVSNet


class PlainCasMVSNet(PlainCvaMVSNet):
    """The cascade with the variance cost volume: FeatureNet, three
    plane-sweep stages, the 3D U-Net and the soft-argmin depth, then the
    edge filter on stage 3."""

    def __init__(self, params: dict, config: dict, quant: str = "none"):
        if config["view_aggregation"]:
            raise ValueError("the variance cascade has no view aggregation")
        if quant not in ("none", "tf32"):
            raise ValueError(f"quant {quant!r}: 'none' or 'tf32'")
        self.p = params
        self.train = False
        self.depth_num = tuple(config["depth_num"])
        self.ratio = tuple(config["depth_interval_ratio"])
        self.view_aggregation = False
        self.q = lambda x: x
        self.tf32 = quant == "tf32"

    def _stage(self, feats, K, c2w, depth_in, stage: str):
        """feats (B, V, C, H, W), K (B, 3, 3), c2w (B, V, 4, 4), depth_in
        (B, D, H, W) -> depth, confidence (B, H, W)."""
        V = feats.shape[1]
        ref = feats[:, 0][:, :, None]                         # (B, C, 1, H, W)
        vol_sum, vol_sq_sum = ref, ref ** 2
        for v in range(1, V):
            warped = self._warp(feats[:, v], K, c2w[:, v], c2w[:, 0],
                                depth_in)
            vol_sum = vol_sum + warped
            vol_sq_sum = vol_sq_sum + warped ** 2
        volume = vol_sq_sum / V - (vol_sum / V) ** 2
        D = depth_in.shape[1]
        logits = self._cost_reg(volume, stage, four=(D == 4))
        prob = torch.softmax(logits, dim=1)
        depth = torch.sum(prob * depth_in, dim=1)
        pad = F.pad(prob, (0, 0, 0, 0, 1, 2))
        prob4 = (pad[:, 0:D] + pad[:, 1:D + 1] + pad[:, 2:D + 2]
                 + pad[:, 3:D + 3])
        steps = torch.arange(D, dtype=torch.float32, device=prob.device)
        idx = torch.sum(prob * steps[None, :, None, None], dim=1).long()
        conf = torch.gather(prob4, 1, idx.clamp(0, D - 1)[:, None])[:, 0]
        return depth, conf
