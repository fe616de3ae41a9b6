"""Plain TransMVSNet inference with the depth-edge filter: the benchmark's
reference for the map path of the transformer cascade.

Written from the published model (Ding et al., "TransMVSNet: Global
Context-aware Multi-view Stereo Network with Transformers", CVPR 2022,
arXiv:2111.14600; its FMT is LoFTR's linear-attention encoder, Sun et al.,
CVPR 2021) in plain torch operations, on ``cva_mvsnet.py``'s layers
(FeatureNet, the 3D U-Net, BatchNorm in its eval form), plane sweep
(``grid_sample``, bilinear, zero padding, corners aligned) and edge
filter:

- ARF: one modulated deformable 3x3 convolution a stage, each tap sampled
  by ``grid_sample`` at p + p_k + offset_k, times its modulation (the
  sigmoid of a 3x3 convolution), contracted with the weights by
  ``einsum``;
- FMT: LoFTR's 2-D sine encoding, then [self, cross] x blocks encoder
  layers, each shared by the views, written with ``einsum`` as LoFTR's
  ``LinearAttention`` (phi = elu + 1, V / S, KV = sum phi(K)^T V, Z = 1 /
  (phi(Q) . sum phi(K) + 1e-6), phi(Q) KV Z S); the reference's tokens
  through the self layer alone, each source view's through the self layer
  and the cross layer on the reference's, a view at a time;
- the pathway: a 1x1 convolution, bilinear upsampling (corners not
  aligned), the finer features added, a 3x3 convolution;
- the correlation of each source view's warped features with the
  reference's, averaged over the channels (one group); stage 1's view
  weights max_d sigmoid(P(sim)), the later stages' upsampled 2x (nearest);
  the cost sum_v w_v sim_v / (1e-5 + sum_v w_v), the views in order;
- the head: the U-Net's logits on the 1-channel volume, softmax, the
  winning plane's depth (``depth_head`` "wta") or the expected depth
  ("regression"), and the 4-plane confidence at the expected index.

It imports nothing of the program and no kernel.

Departures from TransMVSNet's published test, all TANDEM's runtime or not
fixed by the paper (the configuration's ``assumed``):
- the depth-edge filter on stage 3 in place of the photometric and
  geometric consistency filtering after the network;
- the depth range is the caller's (TANDEM's rule), the later stages'
  hypotheses TANDEM's cascade (``cva_mvsnet``);
- ARF as one modulated deformable convolution a stage, without bias, its
  offsets and modulation from 3x3 convolutions with bias;
- the sine encoding computed for the features' own size (LoFTR keeps a
  table of 256 x 256 positions, smaller than stage 1 at 1152 x 864);
- the similarity as the channel mean (one group) and 1e-5 in the weights'
  sum.

Precision: float32 with TF32 off. ``quant="tf32"`` is the control: cuDNN
and the matmuls in TF32.

Inputs: as ``PlainCvaMVSNet``'s (the runtime contract).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .cva_mvsnet import STAGES, PlainCvaMVSNet
from .cva_mvsnet import param_shapes as cascade_shapes

VIEW_WEIGHT_CHANNELS = (16, 8)   # P = 1x1x1 Conv3d 1 -> 16 -> 8 -> 1


class PlainTransMVSNet(PlainCvaMVSNet):
    """FeatureNet, ARF, the FMT and the pathway, three correlation stages
    with pixel-wise view weights, the 3D U-Net and the depth head, then
    the edge filter on stage 3."""

    def __init__(self, params: dict, config: dict, quant: str = "none"):
        if config.get("architecture") != "transmvsnet":
            raise ValueError("the reference is TransMVSNet's")
        if quant not in ("none", "tf32"):
            raise ValueError(f"quant {quant!r}: 'none' or 'tf32'")
        self.p = params
        self.train = False
        self.depth_num = tuple(config["depth_num"])
        self.ratio = tuple(config["depth_interval_ratio"])
        self.view_aggregation = False
        self.q = lambda x: x
        self.tf32 = quant == "tf32"
        fmt = config.get("fmt", {})
        self.heads = fmt.get("heads", 8)
        self.blocks = fmt.get("blocks", 4)
        self.head = config.get("depth_head", "wta")

    # --- ARF -----------------------------------------------------------
    def _dcn(self, x, stage: str):
        """(N, C, H, W) -> (N, C, H, W): y(p) = sum_k w_k m_k(p) x(p + p_k
        + offset_k(p))."""
        a = f"params/arf_{stage}"
        N, C, H, W = x.shape
        offset = self._conv(x, f"{a}/offset/kernel", 2, padding=1,
                            bias=self.p[f"{a}/offset/bias"])
        mod = torch.sigmoid(self._conv(x, f"{a}/mask/kernel", 2, padding=1,
                                       bias=self.p[f"{a}/mask/bias"]))
        w = self.p[f"{a}/conv/kernel"]                   # (3, 3, C, O)
        y, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                            device=x.device),
                               torch.arange(W, dtype=torch.float32,
                                            device=x.device), indexing="ij")
        taps = []
        for k in range(9):
            ky, kx = k // 3, k % 3
            py = y + (ky - 1) + offset[:, 2 * k]
            px = xx + (kx - 1) + offset[:, 2 * k + 1]
            grid = torch.stack([px / ((W - 1) / 2) - 1,
                                py / ((H - 1) / 2) - 1], -1)
            taps.append(F.grid_sample(x, grid, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=True)
                        * mod[:, k:k + 1])
        taps = torch.stack(taps, 2).reshape(N, C, 3, 3, H, W)
        return torch.einsum("ncijhw,ijco->nohw", taps, w)

    # --- FMT -----------------------------------------------------------
    @staticmethod
    def _sine(d: int, h: int, w: int, device):
        pe = torch.zeros(d, h, w, device=device)
        y = torch.ones(h, w, device=device).cumsum(0)[None]
        x = torch.ones(h, w, device=device).cumsum(1)[None]
        div = torch.exp(torch.arange(0, d // 2, 2, device=device).float()
                        * (-math.log(10000.0) / (d // 2)))[:, None, None]
        pe[0::4] = torch.sin(x * div)
        pe[1::4] = torch.cos(x * div)
        pe[2::4] = torch.sin(y * div)
        pe[3::4] = torch.cos(y * div)
        return pe

    def _norm(self, x, path: str):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{path}/scale"],
                            self.p[f"{path}/bias"], 1e-5)

    def _encoder(self, x, source, name: str):
        """LoFTR's encoder layer: x (n, L, d) attends to source (n, S, d)."""
        p = lambda part: self.p[f"params/fmt/{name}/{part}/kernel"]
        n, L, d = x.shape
        h = self.heads
        Q = F.elu((x @ p("q")).reshape(n, L, h, d // h)) + 1
        K = F.elu((source @ p("k")).reshape(n, -1, h, d // h)) + 1
        V = (source @ p("v")).reshape(n, -1, h, d // h)
        S = V.shape[1]
        V = V / S
        KV = torch.einsum("nshd,nshv->nhdv", K, V)
        Z = 1 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + 1e-6)
        msg = torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * S
        msg = self._norm(msg.reshape(n, L, d) @ p("merge"),
                         f"params/fmt/{name}/norm1")
        msg = F.relu(torch.cat([x, msg], -1) @ p("mlp0")) @ p("mlp1")
        return x + self._norm(msg, f"params/fmt/{name}/norm2")

    def _fmt(self, f):
        """(B, V, C, h, w) stage-1 features -> the same after the FMT."""
        B, V, C, h, w = f.shape
        tokens = (f + self._sine(C, h, w, f.device)).reshape(
            B, V, C, h * w).transpose(2, 3)
        ref = tokens[:, 0]
        src = [tokens[:, v] for v in range(1, V)]
        for i in range(self.blocks):
            ref = self._encoder(ref, ref, f"self_{i}")
            src = [self._encoder(self._encoder(s, s, f"self_{i}"), ref,
                                 f"cross_{i}") for s in src]
        out = torch.stack([ref] + src, 1)                # (B, V, hw, C)
        return out.transpose(2, 3).reshape(B, V, C, h, w)

    # --- features ------------------------------------------------------
    def trans_features(self, image):
        """(B, V, 3, H, W) -> {stage: (B, V, C, h, w)}."""
        B, V, C, H, W = image.shape
        feats = self.features(image.reshape(B * V, C, H, W).float())
        f = {s: self._dcn(x, s) for s, x in feats.items()}
        f["stage1"] = self._fmt(f["stage1"].reshape(
            B, V, *f["stage1"].shape[1:])).reshape(f["stage1"].shape)
        for coarse, fine in (("stage1", "stage2"), ("stage2", "stage3")):
            reduced = self._conv(f[coarse],
                                 f"params/pathway/reduce_{fine}/kernel", 2)
            up = F.interpolate(reduced, size=f[fine].shape[2:],
                               mode="bilinear", align_corners=False)
            f[fine] = self._conv(up + f[fine],
                                 f"params/pathway/smooth_{fine}/kernel", 2,
                                 padding=1)
        return {s: x.reshape(B, V, *x.shape[1:]) for s, x in f.items()}

    # --- cost and head -------------------------------------------------
    def _view_weight(self, sim):
        """(B, D, h, w) -> (B, h, w)."""
        x = self._cbr(sim[:, None], "view_weight/conv0", 3, padding=0)
        x = self._cbr(x, "view_weight/conv1", 3, padding=0)
        x = self._conv(x, "params/view_weight/conv2/kernel", 3,
                       bias=self.p["params/view_weight/conv2/bias"])
        return torch.sigmoid(x[:, 0]).max(dim=1).values

    def _trans_stage(self, feats, K, c2w, depth_in, stage: str, weights):
        V = feats.shape[1]
        ref = feats[:, 0]
        num = den = None
        used = []
        for v in range(1, V):
            warped = self._warp(feats[:, v], K, c2w[:, v], c2w[:, 0],
                                depth_in)                  # (B, C, D, h, w)
            sim = (warped * ref[:, :, None]).mean(1)       # (B, D, h, w)
            w = (self._view_weight(sim) if weights is None else
                 F.interpolate(weights[v - 1][:, None], scale_factor=2,
                               mode="nearest")[:, 0])
            used.append(w)
            num = w[:, None] * sim if num is None else num + w[:, None] * sim
            den = w if den is None else den + w
        volume = num / (1e-5 + den[:, None])
        D = depth_in.shape[1]
        logits = self._cost_reg(volume[:, None], stage, four=(D == 4))
        prob = torch.softmax(logits, dim=1)
        steps = torch.arange(D, dtype=torch.float32, device=prob.device)
        idx = torch.sum(prob * steps[None, :, None, None], dim=1).long()
        pad = F.pad(prob, (0, 0, 0, 0, 1, 2))
        prob4 = (pad[:, 0:D] + pad[:, 1:D + 1] + pad[:, 2:D + 2]
                 + pad[:, 3:D + 3])
        conf = torch.gather(prob4, 1, idx.clamp(0, D - 1)[:, None])[:, 0]
        if self.head == "wta":
            best = torch.max(prob, dim=1).indices
            depth = torch.gather(depth_in, 1, best[:, None])[:, 0]
        else:
            depth = torch.sum(prob * depth_in, dim=1)
        return depth, conf, used

    def cascade(self, image, Ks, c2w, depth_min, depth_max) -> dict:
        """{stage: (depth, confidence)} of the three stages."""
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        B, V, C, H, W = image.shape
        feats = self.trans_features(image)
        c2w = c2w.float()
        dmin, dmax = depth_min.float(), depth_max.float()
        out = {}
        base = depth = weights = None
        for i, stage in enumerate(STAGES):
            s = 2 ** (2 - i)
            hs, ws = H // s, W // s
            D = self.depth_num[i]
            if i == 0:
                base = (dmax - dmin) / (D - 1)
                steps = torch.arange(D, dtype=torch.float32,
                                     device=image.device)
                depth_in = (dmin[:, None] + base[:, None] * steps).reshape(
                    B, D, 1, 1).expand(B, D, hs, ws)
            else:
                up = F.interpolate(depth[:, None], size=(hs, ws),
                                   mode="bilinear", align_corners=False)[:, 0]
                interval = (self.ratio[i] * base)[:, None, None]
                lo = torch.clamp(up - D / 2.0 * interval, min=0.001)
                lin = torch.arange(D, dtype=torch.float32,
                                   device=image.device) / D
                depth_in = lo[:, None] + (D * interval)[:, None] \
                    * lin[None, :, None, None]
            depth, conf, weights = self._trans_stage(
                feats[stage], Ks[i].float(), c2w, depth_in.contiguous(),
                stage, weights)
            out[stage] = (depth, conf)
        return out


PLAIN = PlainTransMVSNet


def param_shapes(config: dict) -> dict:
    """{flax path joined by '/': shape} of every parameter and BatchNorm
    statistic (the unit pickle's layout): the cascade's FeatureNet and
    U-Nets (on a 1-channel volume), ARF, the FMT (Dense kernels (in,
    out)), the pathway and the view-weight net."""
    b = config["feature_net_base_channels"]
    out = cascade_shapes(dict(config, view_aggregation=False))
    for i, stage in enumerate(STAGES):
        # conv0 takes the 1-channel volume
        out[f"params/cost_reg_{stage}/conv0/conv/kernel"] = (
            3, 3, 3, 1, config["cost_volume_base_channels"][i])
    chans = {"stage1": 4 * b, "stage2": 2 * b, "stage3": b}
    for stage, c in chans.items():
        a = f"params/arf_{stage}"
        out[f"{a}/offset/kernel"] = (3, 3, c, 18)
        out[f"{a}/offset/bias"] = (18,)
        out[f"{a}/mask/kernel"] = (3, 3, c, 9)
        out[f"{a}/mask/bias"] = (9,)
        out[f"{a}/conv/kernel"] = (3, 3, c, c)
    fmt = config.get("fmt", {})
    d = fmt.get("d_model", 4 * b)
    for i in range(fmt.get("blocks", 4)):
        for name in (f"self_{i}", f"cross_{i}"):
            f = f"params/fmt/{name}"
            for lin in ("q", "k", "v", "merge"):
                out[f"{f}/{lin}/kernel"] = (d, d)
            out[f"{f}/mlp0/kernel"] = (2 * d, 2 * d)
            out[f"{f}/mlp1/kernel"] = (2 * d, d)
            for norm in ("norm1", "norm2"):
                out[f"{f}/{norm}/scale"] = out[f"{f}/{norm}/bias"] = (d,)
    for fine, cin, cout in (("stage2", 4 * b, 2 * b), ("stage3", 2 * b, b)):
        out[f"params/pathway/reduce_{fine}/kernel"] = (1, 1, cin, cout)
        out[f"params/pathway/smooth_{fine}/kernel"] = (3, 3, cout, cout)
    c0, c1 = VIEW_WEIGHT_CHANNELS
    for name, cin, cout in (("conv0", 1, c0), ("conv1", c0, c1)):
        out[f"params/view_weight/{name}/conv/kernel"] = (1, 1, 1, cin, cout)
        for part in ("scale", "bias"):
            out[f"params/view_weight/{name}/bn/{part}"] = (cout,)
        for part in ("mean", "var"):
            out[f"batch_stats/view_weight/{name}/bn/{part}"] = (cout,)
    out["params/view_weight/conv2/kernel"] = (1, 1, 1, c1, 1)
    out["params/view_weight/conv2/bias"] = (1,)
    return out
