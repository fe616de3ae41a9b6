"""TransMVSNet: CasMVSNet's cascade with a Feature Matching Transformer, a
correlation cost volume with pixel-wise view weights and deformable feature
heads, for inference.

Written from the paper (Ding et al., "TransMVSNet: Global Context-aware
Multi-view Stereo Network with Transformers", CVPR 2022, arXiv:2111.14600)
on the port's cascade. V views, the reference first; stage s has features
f_s of C_s = 4b / 2b / b channels at 1/4, 1/2 and 1 of the image:

- FPN: ``FeatureNet(b)``, as CVA-MVSNet's.
- ARF (adaptive receptive field): each stage's features through one
  modulated deformable 3x3 convolution (``layers.ModulatedDeformConv3x3``),
  ahead of the FMT and the pathway.
- FMT on stage 1 (``FeatureMatchingTransformer``): each view's tokens are
  its features plus LoFTR's 2-D sine encoding, flattened; ``blocks`` x
  [self, cross] encoder layers, each shared by all views: the reference's
  tokens go through the self layer alone (R_l), each source's through the
  self layer and then the cross layer with R_l as its keys and values. No
  source updates the reference. The sources go through a layer together.
- Pathway: f_2 <- S_1(up(R_1 f_1) + f_2), f_3 <- S_2(up(R_2 f_2) + f_3), R a
  1x1 and S a 3x3 convolution without bias, up bilinear (corners not
  aligned).
- Cost at each stage: sim_v(d, p) = (1 / C) sum_c f_0(c, p) warp(f_v)(c, d,
  p), one launch of ``ops/bilinear_sample.warp_correlation`` a source view
  on the card; stage 1's view weights w_v(p) = max_d sigmoid(P(sim_v)), P
  1x1x1 Conv3d 1 -> 16 + BN + ReLU, 16 -> 8 + BN + ReLU, 8 -> 1 with bias;
  the later stages take w_v upsampled 2x (nearest) from the stage before;
  cost = sum_v w_v sim_v / (1e-5 + sum_v w_v).
- Head: ``CostRegNet(1, base)`` logits, softmax over the planes; the depth
  is the winning plane's (``depth_head="wta"``, the published head) or the
  expected depth (``"regression"``, TANDEM's); the confidence is the sum
  of 4 plane probabilities at the expected index either way. The depth
  centres the next stage's planes (``ranges.adaptive_depth_range``).

The forward contract, the precision rules (``dtype`` float32 or
bfloat16: features, volumes and layers in ``dtype``, positions,
similarities, weights, softmax and depths in float32), the edge filter and
``Stage3Forward`` are ``CvaMVSNet``'s. Inference only: ``train=True``
raises. ``fmt_events``, when set to a pair of CUDA events, records the
first before the FMT and the second after it on the current stream (the
runner times the FMT with them inside its CUDA graph).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.warp import plane_sweep_correlation, ref_pixel_to_world
from .cost_reg import CostRegNet
from .cva_mvsnet import (STAGES, filtered_outputs, pin_f32_precision,
                         regress_depth)
from .feature_net import FeatureNet
from .layers import (ConvBnRelu, ModulatedDeformConv3x3, conv_in,
                     interpolate_bilinear, upsample_nearest_2x)
from .ranges import adaptive_depth_range, uniform_depth_range

DEPTH_HEADS = ("wta", "regression")
VIEW_WEIGHT_CHANNELS = (16, 8)   # P's hidden widths
ATTENTION_EPS = 1e-6      # LoFTR's linear attention
KV_SPLIT = 64             # parts of the keys' sum over the tokens
WEIGHT_EPS = 1e-5         # the view weights' sum


def sine_encoding(d: int, h: int, w: int, device) -> torch.Tensor:
    """LoFTR's 2-D sine position encoding (d, h, w), float32: channels 4i,
    4i + 1 = sin, cos of x * f_i and 4i + 2, 4i + 3 = sin, cos of y * f_i,
    f_i = exp(-2i ln(10000) / (d / 2)), pixel positions counted from 1."""
    f = torch.exp(torch.arange(0, d // 2, 2, dtype=torch.float32,
                               device=device)
                  * (-math.log(10000.0) / (d // 2)))[:, None, None]
    y = torch.arange(1, h + 1, dtype=torch.float32,
                     device=device)[None, :, None].expand(1, h, w)
    x = torch.arange(1, w + 1, dtype=torch.float32,
                     device=device)[None, None, :].expand(1, h, w)
    return torch.stack([torch.sin(x * f), torch.cos(x * f),
                        torch.sin(y * f), torch.cos(y * f)],
                       1).reshape(d, h, w)


class EncoderLayer(nn.Module):
    """LoFTR's encoder layer with linear attention: E(x, s) = x + LN_2(MLP(
    [x, LN_1(merge(attention(x W_q, s W_k, s W_v)))])), ``heads`` heads of
    d / heads, no bias anywhere but the LayerNorms'."""

    def __init__(self, d: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.q = nn.Linear(d, d, bias=False)
        self.k = nn.Linear(d, d, bias=False)
        self.v = nn.Linear(d, d, bias=False)
        self.merge = nn.Linear(d, d, bias=False)
        self.mlp0 = nn.Linear(2 * d, 2 * d, bias=False)
        self.mlp1 = nn.Linear(2 * d, d, bias=False)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)
        self.heads = heads
        self.dtype = dtype

    def _lin(self, layer, x):
        return F.linear(x, layer.weight.to(self.dtype))

    def _norm(self, layer, x):
        """LayerNorm over the last axis, as elementwise passes and two
        row means: ``F.layer_norm``'s kernel took ~0.43 ms a call on the
        FMT's ~300,000 rows of 32 on the H100 (~90 GB/s)."""
        mean = x.mean(-1, keepdim=True)
        c = x - mean
        var = (c * c).mean(-1, keepdim=True)
        return (c * torch.rsqrt(var + layer.eps) * layer.weight.to(self.dtype)
                + layer.bias.to(self.dtype))

    def keys(self, source) -> tuple:
        """The source's part of the attention, shared by every query of it,
        as block-diagonal (d, d) and (d, heads) matrices so that a query
        takes it with two matrix products of width d (per-head products of
        width d / heads are latency-bound batches): (sum_j phi(K_j)^T V_j /
        S, head h's (e, e) block on the diagonal, e = d / heads; sum_j
        phi(K_j), head h's e entries in column h; S), phi = elu + 1.
        Off the blocks the products are exact zeros."""
        n, S, d = source.shape
        e = d // self.heads
        k = F.elu(self._lin(self.k, source)) + 1
        v = self._lin(self.v, source) / S
        head = torch.arange(d, device=source.device) // e
        block = head[:, None] == head[None, :]
        # the S tokens' sum in KV_SPLIT parts, then the parts': one (d, S) x
        # (S, d) product a view runs on a few blocks of the card
        parts = math.gcd(S, KV_SPLIT)
        kv = (k.reshape(n * parts, S // parts, d).transpose(1, 2)
              @ v.reshape(n * parts, S // parts, d)).reshape(
                  n, parts, d, d).sum(1) * block
        ksum = k.sum(1)[:, :, None] * (
            head[:, None] == torch.arange(self.heads,
                                          device=source.device)[None, :])
        return kv, ksum, S

    def forward(self, x, keys: tuple):
        """:param x: (n, L, d) queries; ``keys``: ``self.keys`` of the
        source, its n dividing x's (a source serves n / its n queries in
        turn) -> (n, L, d)"""
        n, L, d = x.shape
        kv, ksum, S = keys
        rep = n // kv.shape[0]
        if rep > 1:
            kv = kv.repeat_interleave(rep, 0)
            ksum = ksum.repeat_interleave(rep, 0)
        q = F.elu(self._lin(self.q, x)) + 1
        z = 1 / (q @ ksum + ATTENTION_EPS)                  # (n, L, heads)
        msg = (q @ kv) * z.repeat_interleave(d // self.heads, 2) * S
        msg = self._norm(self.norm1, self._lin(self.merge, msg))
        msg = self._lin(self.mlp1, F.relu(self._lin(
            self.mlp0, torch.cat([x, msg], -1))))
        return x + self._norm(self.norm2, msg)


class FeatureMatchingTransformer(nn.Module):
    """``blocks`` x [self, cross] encoder layers over each view's stage-1
    tokens (the module's docstring)."""

    def __init__(self, d: int, heads: int, blocks: int, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(d, heads, dtype)
                                    for _ in range(2 * blocks))
        self.dtype = dtype

    def forward(self, f):
        """:param f: (B, V, C, h, w), the reference first -> the same"""
        B, V, C, h, w = f.shape
        pe = sine_encoding(C, h, w, f.device)
        x = (f.float() + pe).to(self.dtype).reshape(B, V, C, h * w)
        x = x.transpose(2, 3).reshape(B * V, h * w, C)
        for i in range(0, len(self.layers), 2):
            self_layer, cross = self.layers[i], self.layers[i + 1]
            # every view through the self layer (each its own keys)
            x = self_layer(x, self_layer.keys(x)).reshape(B, V, h * w, C)
            ref, src = x[:, 0], x[:, 1:].reshape(B * (V - 1), h * w, C)
            src = cross(src, cross.keys(ref))
            x = torch.cat([ref[:, None], src.reshape(B, V - 1, h * w, C)],
                          1).reshape(B * V, h * w, C)
        return x.reshape(B, V, h, w, C).permute(0, 1, 4, 2, 3)


class TransMVSNet(nn.Module):
    architecture = "transmvsnet"
    view_aggregation = False

    def __init__(self, depth_num: Tuple[int, ...] = (48, 32, 8),
                 depth_interval_ratio: Tuple[float, ...] = (1.0, 0.5, 0.25),
                 feature_net_base_channels: int = 8,
                 cost_volume_base_channels: Tuple[int, ...] = (8, 8, 8),
                 fmt: Optional[dict] = None, depth_head: str = "wta",
                 dtype=torch.float32):
        super().__init__()
        fmt = dict({"d_model": 32, "heads": 8, "blocks": 4}, **(fmt or {}))
        b = feature_net_base_channels
        if len(depth_num) != 3 or depth_interval_ratio[0] != 1.0:
            raise ValueError("TransMVSNet needs 3 stages and ratio[0] == 1")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"TransMVSNet dtype {dtype}: float32 or "
                             "bfloat16")
        if depth_head not in DEPTH_HEADS:
            raise ValueError(f"depth_head {depth_head!r}: one of "
                             f"{DEPTH_HEADS}")
        if fmt["d_model"] != 4 * b or fmt["d_model"] % fmt["heads"]:
            raise ValueError(f"the FMT's width {fmt['d_model']} must be the "
                             f"stage-1 features' {4 * b} and split into "
                             f"{fmt['heads']} heads")
        pin_f32_precision()
        self.dtype = dtype
        self.depth_num = tuple(depth_num)
        self.depth_interval_ratio = tuple(depth_interval_ratio)
        self.depth_head = depth_head
        self.scale = {s: 2 ** (2 - i) for i, s in enumerate(STAGES)}
        self.feature_net = FeatureNet(b, dtype)
        fc = self.feature_net.out_channels
        self.arf = nn.ModuleDict({s: ModulatedDeformConv3x3(fc[s], fc[s],
                                                            dtype)
                                  for s in STAGES})
        self.fmt = FeatureMatchingTransformer(fmt["d_model"], fmt["heads"],
                                              fmt["blocks"], dtype)
        self.pathway = nn.ModuleDict({
            "reduce": nn.ModuleDict({
                "stage2": nn.Conv2d(4 * b, 2 * b, 1, bias=False),
                "stage3": nn.Conv2d(2 * b, b, 1, bias=False)}),
            "smooth": nn.ModuleDict({
                "stage2": nn.Conv2d(2 * b, 2 * b, 3, padding=1, bias=False),
                "stage3": nn.Conv2d(b, b, 3, padding=1, bias=False)})})
        c0, c1 = VIEW_WEIGHT_CHANNELS
        kw = dict(ndim=3, dtype=dtype)
        self.view_weight = nn.ModuleDict({
            "conv0": ConvBnRelu(1, c0, 1, **kw),
            "conv1": ConvBnRelu(c0, c1, 1, **kw),
            "conv2": nn.Conv3d(c1, 1, 1, bias=True)})
        self.cost_regularization_net = nn.ModuleDict({
            s: CostRegNet(1, cost_volume_base_channels[i],
                          has_four_depths=self.depth_num[i] == 4,
                          dtype=dtype)
            for i, s in enumerate(STAGES)})
        self.fmt_events = None

    def forward(self, image, intrinsic_matrix, cam_to_world, depth_min,
                depth_max, depth_filter_discard_percentage=None,
                train: bool = False):
        """``CvaMVSNet.forward``'s contract, inference only."""
        with torch.no_grad():
            return self._forward(image, intrinsic_matrix, cam_to_world,
                                 depth_min, depth_max,
                                 depth_filter_discard_percentage, train)

    def features(self, image):
        """(B, V, 3, H, W) -> {stage: (B, V, h, w, C) channels last}: the
        FPN, ARF, the FMT on stage 1 and the pathway."""
        B, V, C, H, W = image.shape
        dt = self.dtype
        feats = self.feature_net(image.reshape(B * V, C, H, W).float())
        f = {s: self.arf[s](x) for s, x in feats.items()}
        events = self.fmt_events if image.is_cuda else None
        if events is not None:
            events[0].record()
        f1 = self.fmt(f["stage1"].reshape(B, V, *f["stage1"].shape[1:]))
        if events is not None:
            events[1].record()
        f["stage1"] = f1.reshape(B * V, *f1.shape[2:])
        for coarse, fine in (("stage1", "stage2"), ("stage2", "stage3")):
            reduced = conv_in(self.pathway["reduce"][fine], f[coarse], dt)
            up = F.interpolate(reduced, size=f[fine].shape[2:],
                               mode="bilinear", align_corners=False)
            f[fine] = conv_in(self.pathway["smooth"][fine], up + f[fine], dt)
        return {s: x.permute(0, 2, 3, 1).contiguous().reshape(
                    B, V, *x.shape[2:], x.shape[1]) for s, x in f.items()}

    def _forward(self, image, intrinsic_matrix, cam_to_world, depth_min,
                 depth_max, depth_filter_discard_percentage, train: bool):
        if train:
            raise NotImplementedError("TransMVSNet is served for inference "
                                      "only")
        B, V, _, H, W = image.shape
        features = self.features(image)
        outputs = {}
        base_interval = weights = None
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
            depth, conf, weights = self._stage(
                features[stage], intrinsic_matrix[i], cam_to_world,
                depth_samples, self.cost_regularization_net[stage], weights)
            outputs[stage] = (depth, conf)
        return filtered_outputs(outputs, depth_filter_discard_percentage)

    def _view_weight(self, sim):
        """(B, D, h, w) similarity -> (B, h, w) float32: max over the
        planes of sigmoid(P(sim))."""
        net, dt = self.view_weight, self.dtype
        x = net["conv1"](net["conv0"](sim[:, None]))
        y = conv_in(net["conv2"], x, dt)[:, 0].float()
        return torch.sigmoid(y).amax(1)

    def _stage(self, features, K, cam_to_world, depth_in,
               cost_reg: CostRegNet, weights):
        """One cascade stage.

        :param features: (B, V, h, w, C), the reference first
        :param weights: the stage before's view weights (V - 1 of (B, h/2,
            w/2)), None at stage 1
        :return: depth, confidence (B, h, w) and this stage's view weights
        """
        V = features.shape[1]
        ref = features[:, 0].contiguous()
        ref_p2w = ref_pixel_to_world(K, cam_to_world[:, 0])
        num = den = None
        used = []
        for v in range(1, V):
            sim = plane_sweep_correlation(
                features[:, v], ref, depth_in, src_K=K,
                src_cam_to_world=cam_to_world[:, v], ref_p2w=ref_p2w)
            w = (self._view_weight(sim) if weights is None else
                 upsample_nearest_2x(weights[v - 1][:, None])[:, 0])
            used.append(w)
            term = w[:, None] * sim
            num = term if num is None else num + term
            den = w if den is None else den + w
        volume = num / (den[:, None] + WEIGHT_EPS)
        logits = cost_reg(volume[:, None].to(self.dtype))
        prob = torch.softmax(logits.float(), dim=1)
        depth, conf = regress_depth(prob, depth_in)
        if self.depth_head == "wta":
            depth = torch.gather(depth_in.float(), 1,
                                 prob.argmax(1)[:, None])[:, 0]
        return depth, conf, used
