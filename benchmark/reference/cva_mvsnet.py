"""Plain CVA-MVSNet inference with the depth-edge filter: the benchmark's
reference for the map path.

Written from the published model (CVA-MVSNet, Kuhn et al., TANDEM, CoRL
2021; cva_mvsnet/models/{cva_mvsnet,module}.py of the TANDEM repository) in
plain torch operations: ``conv2d`` / ``conv3d`` / ``conv_transpose3d``,
BatchNorm in its eval form, and the plane sweep as ``grid_sample``
(bilinear, zero padding, corners aligned). It imports nothing of the
program. The weights come from the unit's ``model_variables.pkl``, a pickle
of numpy arrays in flax's layouts, converted here.

Precision: float32 with TF32 off, the configuration's reference precision.
``train=True`` is the training forward: BatchNorm normalises with the
batch's statistics (the biased variance E[x^2] - E[x]^2, as flax's and
the program's training BatchNorm), gradients flow to every parameter
(leaf tensors of ``params``), and stop at the previous stage's depth and
at the confidence, as the published training does.
``quant="fp8"`` is the control of a bfloat16 configuration: every
convolution's input and weights, the warped features and the cost volume
are stored as float8 e4m3 (per-tensor scale to the format's largest
value), accumulated in float32, as an fp8 inference path would compute
them. ``quant="tf32"`` is the control of a float32 one: cuDNN and the
matmuls in TF32.

Inputs (the runtime contract): image (B, V, 3, H, W) in [0, 1] with the
reference view first, the stage intrinsics (3 x (B, 3, 3)), cam_to_world
(B, V, 4, 4), depth_min and depth_max (B,).
"""

from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
FP8_MAX = 448.0          # float8 e4m3fn's largest finite value
EDGE_WINDOW = 5
EDGE_RANK = 15           # the 15th smallest |difference| of the 5 x 5 window
MIN_DEPTH = 0.001        # samples nearer than this to the source are dropped
STAGES = ("stage1", "stage2", "stage3")


def load_params(path: str, device) -> dict:
    """The unit's pickle as {flax path joined by '/': float32 tensor}."""
    with open(path, "rb") as f:
        tree = pickle.load(f)
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = torch.as_tensor(
                    np.asarray(v, np.float32), device=device)
    walk(tree, "")
    return out


def _fp8(x):
    """x stored as float8 e4m3 with a per-tensor scale, read back in f32."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class PlainCvaMVSNet:
    """The cascade: FeatureNet, three plane-sweep stages with the gated
    view aggregation, the 3D U-Net and the soft-argmin depth, then the
    edge filter on stage 3."""

    def __init__(self, params: dict, config: dict, quant: str = "none",
                 train: bool = False):
        self.p = params
        self.train = train
        self.depth_num = tuple(config["depth_num"])
        self.ratio = tuple(config["depth_interval_ratio"])
        self.view_aggregation = bool(config["view_aggregation"])
        if not self.view_aggregation:
            raise ValueError("the reference implements the gated cascade")
        if quant not in ("none", "fp8", "tf32"):
            raise ValueError(f"quant {quant!r}: 'none', 'fp8' or 'tf32'")
        self.q = _fp8 if quant == "fp8" else (lambda x: x)
        self.tf32 = quant == "tf32"

    # --- layers --------------------------------------------------------
    def _w(self, name: str, ndim: int):
        """A flax kernel (k..., I, O) as torch's (O, I, k...)."""
        w = self.p[name]
        return w.permute(ndim + 1, ndim, *range(ndim)).contiguous()

    def _bn(self, x, path: str):
        scale = self.p[f"params/{path}/scale"]
        bias = self.p[f"params/{path}/bias"]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.train:
            dims = [0] + list(range(2, x.dim()))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            return ((x - mean.reshape(shape))
                    * (torch.rsqrt(var + BN_EPS) * scale).reshape(shape)
                    + bias.reshape(shape))
        mean = self.p[f"batch_stats/{path}/mean"]
        var = self.p[f"batch_stats/{path}/var"]
        return ((x - mean.reshape(shape)) / torch.sqrt(var.reshape(shape)
                                                       + BN_EPS)
                * scale.reshape(shape) + bias.reshape(shape))

    def _conv(self, x, name: str, ndim: int, stride=1, padding=0, bias=None):
        conv = F.conv2d if ndim == 2 else F.conv3d
        return conv(self.q(x), self.q(self._w(name, ndim)), bias, stride,
                    padding)

    def _cbr(self, x, path: str, ndim: int, stride=1, padding=1):
        x = self._conv(x, f"params/{path}/conv/kernel", ndim, stride, padding)
        return F.relu(self._bn(x, f"{path}/bn"))

    def _deconv_bn_relu(self, x, path: str, stride, output_padding):
        # flax stores the transposed kernel spatially flipped, (k, k, k, I, O)
        w = self.p[f"params/{path}/kernel"].flip(0, 1, 2)
        w = w.permute(3, 4, 0, 1, 2).contiguous()          # (I, O, k, k, k)
        x = F.conv_transpose3d(self.q(x), self.q(w), None, stride, 1,
                               output_padding)
        return F.relu(self._bn(x, f"{path}/bn"))

    # --- FeatureNet ----------------------------------------------------
    def features(self, x):
        """(N, 3, H, W) -> {stage: (N, C, H/s, W/s)}."""
        fn = "feature_net"
        c = self._cbr(x, f"{fn}/conv0_0", 2)
        c = self._cbr(c, f"{fn}/conv0_1", 2)
        s3 = c
        c = self._cbr(s3, f"{fn}/conv1_0", 2, 2, 2)
        c = self._cbr(c, f"{fn}/conv1_1", 2)
        s2 = self._cbr(c, f"{fn}/conv1_2", 2)
        c = self._cbr(s2, f"{fn}/conv2_0", 2, 2, 2)
        c = self._cbr(c, f"{fn}/conv2_1", 2)
        s1 = self._cbr(c, f"{fn}/conv2_2", 2)

        def skip(name, x):
            return self._conv(x, f"params/{fn}/{name}/kernel", 2,
                              bias=self.p[f"params/{fn}/{name}/bias"])
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        inter2 = up(s1) + skip("skip_stage2", s2)
        inter3 = up(inter2) + skip("skip_stage3", s3)
        return {"stage1": self._conv(s1, f"params/{fn}/out_stage1/kernel", 2),
                "stage2": self._conv(inter2,
                                     f"params/{fn}/out_stage2/kernel", 2,
                                     padding=1),
                "stage3": self._conv(inter3,
                                     f"params/{fn}/out_stage3/kernel", 2,
                                     padding=1)}

    # --- plane sweep ---------------------------------------------------
    @staticmethod
    def _warp(src, K, src_c2w, ref_c2w, depth):
        """Bilinear samples of src (B, C, H, W) at every reference pixel and
        depth hypothesis (B, D, H, W) -> (B, C, D, H, W)."""
        B, C, H, W = src.shape
        D = depth.shape[1]
        dev = src.device
        Kh = torch.eye(4, device=dev).repeat(B, 1, 1)
        Kh[:, :3, :3] = K
        src_proj = Kh @ torch.linalg.inv(src_c2w)
        ref_proj = Kh @ torch.linalg.inv(ref_c2w)
        proj = src_proj @ torch.linalg.inv(ref_proj)
        rot, trans = proj[:, :3, :3], proj[:, :3, 3]
        y, x = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                           device=dev),
                              torch.arange(W, dtype=torch.float32,
                                           device=dev), indexing="ij")
        xyz = torch.stack([x.reshape(-1), y.reshape(-1),
                           torch.ones(H * W, device=dev)])     # (3, HW)
        rays = (rot @ xyz)[:, :, None, :] * depth.reshape(B, 1, D, H * W) \
            + trans[:, :, None, None]                        # (B, 3, D, HW)
        z = rays[:, 2]
        z_safe = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
        px, py = rays[:, 0] / z_safe, rays[:, 1] / z_safe
        behind = z < MIN_DEPTH
        # behind the source camera: a position no corner reaches
        px = torch.where(behind, torch.full_like(px, -10.0), px)
        py = torch.where(behind, torch.full_like(py, -10.0), py)
        grid = torch.stack([px / ((W - 1) / 2) - 1, py / ((H - 1) / 2) - 1],
                           -1).reshape(B, D * H, W, 2)
        out = F.grid_sample(src, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=True)
        return out.reshape(B, C, D, H, W)

    def _gate(self, diff_sq, stage: str):
        g = f"volume_gate_{stage}"
        w0 = self.p[f"params/{g}/gate0/kernel"].reshape(-1)
        y = torch.einsum("bcdhw,c->bdhw", self.q(diff_sq), self.q(w0)) \
            + self.p[f"params/{g}/gate0/bias"]
        y = F.relu(self._bn(y[:, None], f"{g}/bn0"))
        y = y * self.p[f"params/{g}/gate1/kernel"].reshape(()) \
            + self.p[f"params/{g}/gate1/bias"]
        return F.relu(self._bn(y, f"{g}/bn1"))                # (B, 1, D, H, W)

    def _cost_reg(self, x, stage: str, four: bool):
        r = f"cost_reg_{stage}"
        s5 = (1, 2, 2) if four else 2
        op5 = (0, 1, 1) if four else 1
        c0 = self._cbr(x, f"{r}/conv0", 3)
        c2 = self._cbr(self._cbr(c0, f"{r}/conv1", 3, 2), f"{r}/conv2", 3)
        c4 = self._cbr(self._cbr(c2, f"{r}/conv3", 3, 2), f"{r}/conv4", 3)
        x = self._cbr(self._cbr(c4, f"{r}/conv5", 3, s5), f"{r}/conv6", 3)
        x = c4 + self._deconv_bn_relu(x, f"{r}/conv7", s5, op5)
        x = c2 + self._deconv_bn_relu(x, f"{r}/conv9", 2, 1)
        x = c0 + self._deconv_bn_relu(x, f"{r}/conv11", 2, 1)
        return self._conv(x, f"params/{r}/prob/kernel", 3, padding=1)[:, 0]

    def _stage(self, feats, K, c2w, depth_in, stage: str):
        """feats (B, V, C, H, W), K (B, 3, 3), c2w (B, V, 4, 4), depth_in
        (B, D, H, W) -> depth, confidence (B, H, W)."""
        V = feats.shape[1]
        ref = self.q(feats[:, 0])[:, :, None]                 # (B, C, 1, H, W)
        acc = None
        for v in range(1, V):
            warped = self.q(self._warp(feats[:, v], K, c2w[:, v], c2w[:, 0],
                                       depth_in))
            diff_sq = (warped - ref) ** 2
            term = (self._gate(diff_sq, stage) + 1.0) * diff_sq
            acc = term if acc is None else acc + term
        volume = self.q(acc / (V - 1))
        D = depth_in.shape[1]
        logits = self._cost_reg(volume, stage, four=(D == 4))
        prob = torch.softmax(logits, dim=1)
        depth = torch.sum(prob * depth_in, dim=1)
        with torch.no_grad():
            pad = F.pad(prob, (0, 0, 0, 0, 1, 2))
            prob4 = (pad[:, 0:D] + pad[:, 1:D + 1] + pad[:, 2:D + 2]
                     + pad[:, 3:D + 3])
            steps = torch.arange(D, dtype=torch.float32, device=prob.device)
            idx = torch.sum(prob * steps[None, :, None, None], dim=1).long()
            idx = idx.clamp(0, D - 1)
            conf = torch.gather(prob4, 1, idx[:, None])[:, 0]
        return depth, conf

    def cascade(self, image, Ks, c2w, depth_min, depth_max) -> dict:
        """{stage: (depth, confidence)} of the three stages, each (B, H_s,
        W_s) float32."""
        torch.backends.cudnn.allow_tf32 = self.tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        B, V, C, H, W = image.shape
        feats = self.features(image.reshape(B * V, C, H, W).float())
        c2w = c2w.float()
        dmin, dmax = depth_min.float(), depth_max.float()
        out = {}
        base = depth = None
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
                up = F.interpolate(depth.detach()[:, None], size=(hs, ws),
                                   mode="bilinear", align_corners=False)[:, 0]
                interval = (self.ratio[i] * base)[:, None, None]
                lo = torch.clamp(up - D / 2.0 * interval, min=0.001)
                lin = torch.arange(D, dtype=torch.float32,
                                   device=image.device) / D
                depth_in = lo[:, None] + (D * interval)[:, None] \
                    * lin[None, :, None, None]
            f = feats[stage]
            f = f.reshape(B, V, *f.shape[1:])
            depth, conf = self._stage(f, Ks[i].float(), c2w,
                                      depth_in.contiguous(), stage)
            out[stage] = (depth, conf)
        return out

    # --- the whole forward ---------------------------------------------
    def __call__(self, image, Ks, c2w, depth_min, depth_max,
                 discard_percentage):
        """Inference -> (filtered depth, filtered confidence, depth,
        confidence) of stage 3, each (B, H, W) float32."""
        with torch.no_grad():
            depth, conf = self.cascade(image, Ks, c2w, depth_min,
                                       depth_max)["stage3"]
            fdepth, fconf = edge_filter(depth, conf,
                                        float(discard_percentage))
        return fdepth, fconf, depth, conf


def edge_filter(depth, conf, discard_percentage: float):
    """Zero the pixels whose edge value (the EDGE_RANK-th smallest absolute
    depth difference over the zero-padded 5 x 5 window) is above the
    image's k-th edge value, k = trunc(H W (100 - p) / 100) of the sorted
    values (float32 arithmetic, as the model's filter)."""
    B, H, W = depth.shape
    h = EDGE_WINDOW // 2
    pad = F.pad(depth, (h, h, h, h))
    shifts = torch.stack([pad[:, dy:dy + H, dx:dx + W]
                          for dy in range(EDGE_WINDOW)
                          for dx in range(EDGE_WINDOW)], -1)
    edge = torch.sort((shifts - depth[..., None]).abs(), -1).values[
        ..., EDGE_RANK - 1]
    hw = H * W
    p = torch.tensor(discard_percentage, dtype=torch.float32)
    k = int((hw * (100.0 - p) / 100.0).to(torch.int32))
    k = min(max(k, 0), hw - 1)
    thres = torch.sort(edge.reshape(B, -1), -1).values[:, k]
    keep = edge <= thres[:, None, None]
    return depth * keep, conf * keep


def param_shapes(config: dict) -> dict:
    """{flax path joined by '/': shape} of every parameter and BatchNorm
    statistic of the cascade (the unit pickle's layout): convolution
    kernels (k..., in, out), the transposed ones stored flipped."""
    b = config["feature_net_base_channels"]
    out = {}

    def bn(path, c):
        out[f"params/{path}/scale"] = out[f"params/{path}/bias"] = (c,)
        out[f"batch_stats/{path}/mean"] = out[f"batch_stats/{path}/var"] = \
            (c,)

    def cbr(path, k, cin, cout, nd):
        out[f"params/{path}/conv/kernel"] = (k,) * nd + (cin, cout)
        bn(f"{path}/bn", cout)

    fn = "feature_net"
    for name, k, cin, cout in (("conv0_0", 3, 3, b), ("conv0_1", 3, b, b),
                               ("conv1_0", 5, b, 2 * b),
                               ("conv1_1", 3, 2 * b, 2 * b),
                               ("conv1_2", 3, 2 * b, 2 * b),
                               ("conv2_0", 5, 2 * b, 4 * b),
                               ("conv2_1", 3, 4 * b, 4 * b),
                               ("conv2_2", 3, 4 * b, 4 * b)):
        cbr(f"{fn}/{name}", k, cin, cout, 2)
    for name, k, cin, cout in (("out_stage1", 1, 4 * b, 4 * b),
                               ("out_stage2", 3, 4 * b, 2 * b),
                               ("out_stage3", 3, 4 * b, b)):
        out[f"params/{fn}/{name}/kernel"] = (k, k, cin, cout)
    for name, cin in (("skip_stage2", 2 * b), ("skip_stage3", b)):
        out[f"params/{fn}/{name}/kernel"] = (1, 1, cin, 4 * b)
        out[f"params/{fn}/{name}/bias"] = (4 * b,)
    chans = {"stage1": 4 * b, "stage2": 2 * b, "stage3": b}
    for i, stage in enumerate(STAGES):
        c, v = chans[stage], config["cost_volume_base_channels"][i]
        r = f"cost_reg_{stage}"
        for name, cin, cout in (("conv0", c, v), ("conv1", v, 2 * v),
                                ("conv2", 2 * v, 2 * v),
                                ("conv3", 2 * v, 4 * v),
                                ("conv4", 4 * v, 4 * v),
                                ("conv5", 4 * v, 8 * v),
                                ("conv6", 8 * v, 8 * v)):
            cbr(f"{r}/{name}", 3, cin, cout, 3)
        for name, cin, cout in (("conv7", 8 * v, 4 * v),
                                ("conv9", 4 * v, 2 * v),
                                ("conv11", 2 * v, v)):
            out[f"params/{r}/{name}/kernel"] = (3, 3, 3, cin, cout)
            bn(f"{r}/{name}/bn", cout)
        out[f"params/{r}/prob/kernel"] = (3, 3, 3, v, 1)
        if config["view_aggregation"]:
            g = f"volume_gate_{stage}"
            out[f"params/{g}/gate0/kernel"] = (1, 1, 1, c, 1)
            out[f"params/{g}/gate1/kernel"] = (1, 1, 1, 1, 1)
            out[f"params/{g}/gate0/bias"] = out[f"params/{g}/gate1/bias"] = (1,)
            bn(f"{g}/bn0", 1)
            bn(f"{g}/bn1", 1)
    return out
