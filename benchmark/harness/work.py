"""The yardstick: the card's peaks and the work of a call, counted from its
shapes, whatever implements it.

Peaks are NVIDIA's H100 SXM data sheet's (dense, at the 700 W limit). The
sample's, its backward's and the tracker LM's counts are copies of
``chip_smoke.py``'s (``SAMPLE_OPS``, ``TRACK_OPS``, ``_bound``,
``_track_bound`` and the backward's count of the samples read); the MVSNet's
operations are its convolutions' multiply-adds (two operations each),
counted from the configuration.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # bfloat16 on the tensor cores, dense
PEAK_OPS_PER_S = {"float32": F32_OPS_PER_S, "bfloat16": BF16_OPS_PER_S}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}
# The plane-sweep sample's work per sample besides 7 per channel for the
# blend: ~15 for the projection and its two divisions, ~15 for the floor,
# the weights and the in-bounds test, ~10 for the corner addresses.
SAMPLE_OPS = 40
# The tracker's work per (valid point, candidate) and evaluation:
# projection ~20, bilinear sample of three planes ~30, residual and Huber
# ~10, Jacobian ~20, the 44 sums of H and g ~100.
TRACK_OPS = 180


def bound_s(nbytes: float, ops: float,
            ops_per_s: float = F32_OPS_PER_S) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over their rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def stage_shapes(config: dict, height: int, width: int
                 ) -> Dict[str, Tuple[int, int, int, int]]:
    """(depth planes, H, W, feature channels) of each cascade stage."""
    b = config["feature_net_base_channels"]
    chans = (4 * b, 2 * b, b)
    return {f"stage{i + 1}": (config["depth_num"][i], height >> (2 - i),
                              width >> (2 - i), chans[i])
            for i in range(3)}


def sample_work(D: int, H: int, W: int, C: int, dtype: str
                ) -> Tuple[int, int]:
    """(bytes, operations) of one view's plane-sweep sample: the source
    features, the depth planes (float32) and the 3 x 4 matrix read once,
    the (D, H, W, C) samples written once."""
    e = DTYPE_BYTES[dtype]
    nbytes = H * W * C * e + D * H * W * 4 + 48 + D * H * W * C * e
    return nbytes, D * H * W * (SAMPLE_OPS + 7 * C)


def grad_read_samples(ref_to_src, depth, H: int, W: int,
                      min_depth: float = 0.001):
    """The samples of a plane sweep whose source position lies in front of
    the source camera with a corner in its (H, W) image: those whose
    incoming gradient the backward has to read. A 0-d tensor on the
    inputs' device (no host read); the positions as the sweep computes
    them (ref_to_src (B, 3, 4) times the pixel and depth)."""
    f32 = torch.float32
    gy, gx = torch.meshgrid(torch.arange(H, dtype=f32, device=depth.device),
                            torch.arange(W, dtype=f32, device=depth.device),
                            indexing="ij")

    def component(i):
        ray = (ref_to_src[:, i, 0, None, None] * gx
               + ref_to_src[:, i, 1, None, None] * gy
               + ref_to_src[:, i, 2, None, None])
        return ray[:, None] * depth + ref_to_src[:, i, 3, None, None, None]

    z = component(2)
    z_safe = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    px, py = component(0) / z_safe, component(1) / z_safe
    return (~(z < min_depth) & (px > -1) & (px < W) & (py > -1)
            & (py < H)).sum()


def sample_grad_work(B: int, D: int, H: int, W: int, C: int,
                     grad_bytes: int, read: int) -> Tuple[int, int]:
    """(bytes, operations) of one plane sweep's backward: the incoming
    gradient of the ``read`` samples that land in the image, the matrices
    and the depth planes read once, the float32 sums written once;
    SAMPLE_OPS a sample for its position, and 8 a channel (4 corner
    weights, 4 adds) for each sample read (a copy of ``chip_smoke.py``'s
    count)."""
    nbytes = read * C * grad_bytes + B * 12 * 4 + B * D * H * W * 4 \
        + B * H * W * C * 4
    return nbytes, B * D * H * W * SAMPLE_OPS + read * 8 * C


def _conv(spatial_out: int, cin: int, cout: int, taps: int) -> int:
    return 2 * spatial_out * cin * cout * taps


def _down(n: int) -> int:
    """Output length of a stride-2, kernel-3, padding-1 convolution."""
    return (n + 1) // 2


def cost_reg_ops(D: int, H: int, W: int, cin: int, b: int) -> int:
    """The 3D U-Net's multiply-adds x 2 on a (D, H, W) volume."""
    four = D == 4
    s0 = (D, H, W)
    s1 = tuple(_down(n) for n in s0)
    s2 = tuple(_down(n) for n in s1)
    s3 = (s2[0] if four else _down(s2[0]), _down(s2[1]), _down(s2[2]))
    vol = lambda s: s[0] * s[1] * s[2]
    ops = _conv(vol(s0), cin, b, 27)                       # conv0
    ops += _conv(vol(s1), b, 2 * b, 27) + _conv(vol(s1), 2 * b, 2 * b, 27)
    ops += _conv(vol(s2), 2 * b, 4 * b, 27) + _conv(vol(s2), 4 * b, 4 * b,
                                                    27)
    ops += _conv(vol(s3), 4 * b, 8 * b, 27) + _conv(vol(s3), 8 * b, 8 * b,
                                                    27)
    # transposed convolutions: every input element meets 27 x cout taps
    ops += _conv(vol(s3), 8 * b, 4 * b, 27)                # conv7
    ops += _conv(vol(s2), 4 * b, 2 * b, 27)                # conv9
    ops += _conv(vol(s1), 2 * b, b, 27)                    # conv11
    ops += _conv(vol(s0), b, 1, 27)                        # prob
    return ops


def feature_net_ops(H: int, W: int, b: int) -> int:
    """One image's FeatureNet multiply-adds x 2."""
    h2, w2, h4, w4 = H // 2, W // 2, H // 4, W // 4
    ops = _conv(H * W, 3, b, 9) + _conv(H * W, b, b, 9)
    ops += _conv(h2 * w2, b, 2 * b, 25) + 2 * _conv(h2 * w2, 2 * b, 2 * b, 9)
    ops += _conv(h4 * w4, 2 * b, 4 * b, 25) + 2 * _conv(h4 * w4, 4 * b,
                                                        4 * b, 9)
    ops += _conv(h4 * w4, 4 * b, 4 * b, 1)                 # out stage 1
    ops += _conv(h2 * w2, 2 * b, 4 * b, 1)                 # skip stage 2
    ops += _conv(h2 * w2, 4 * b, 2 * b, 9)                 # out stage 2
    ops += _conv(H * W, b, 4 * b, 1)                       # skip stage 3
    ops += _conv(H * W, 4 * b, b, 9)                       # out stage 3
    return ops


def mvsnet_ops(config: dict, height: int, width: int, views: int) -> int:
    """One keyframe's CVA-MVSNet forward: the V images' FeatureNet, each
    source view's gate contraction and each stage's U-Net."""
    b = config["feature_net_base_channels"]
    ops = views * feature_net_ops(height, width, b)
    for i, (D, H, W, C) in enumerate(stage_shapes(config, height,
                                                  width).values()):
        if config.get("view_aggregation"):
            ops += (views - 1) * 2 * D * H * W * C
        ops += cost_reg_ops(D, H, W, C, config["cost_volume_base_channels"][i])
    return ops


def track_lm_work(B: int, n_points: int, valid: int, H: int, W: int,
                  evaluations: int) -> Tuple[int, int]:
    """(bytes, operations) of one LM level call: the candidates' poses and
    affine pairs, the points (four float32 arrays and the valid mask) and
    the three (H, W) float32 planes read once, the result written once;
    ``evaluations`` x TRACK_OPS per valid point and candidate."""
    nbytes = B * 16 * 4 + B * 2 * 4 + n_points * (4 * 4 + 1) \
        + 3 * H * W * 4 + (B * 20 + 1) * 4
    return nbytes, evaluations * TRACK_OPS * valid * B


def share_percent(bounds_s: Iterable[float], times_s: Iterable[float]):
    """100 x the summed least times over the summed measured times."""
    b, t = sum(bounds_s), sum(times_s)
    return None if t <= 0 else 100.0 * b / t
