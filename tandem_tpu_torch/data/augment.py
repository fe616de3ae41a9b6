"""Training-time augmentation: colour jitter + motion blur as torch ops.

Port of ``tandem_tpu/data/augment.py`` (the reference's kornia pipeline,
cva_mvsnet/models/datasets.py:26-52; config keys AUG.*): ColorJitter
(brightness, contrast, saturation, hue as a YIQ rotation) and
RandomMotionBlur (kernel size, angle, direction), per view or shared by the
views of a tuple (SAME_ON_VIEWS), on the batch's device.

The random factors are drawn from an explicit ``torch.Generator`` (the CLI
seeds it from TRAIN.SEED + 1, as the JAX CLI seeds its key); they cannot
equal ``jax.random``'s draws. The functions that take the drawn factors
(``color_jitter``, ``motion_blur_kernel``, ``motion_blur``) compute what
the JAX package's do with the same factors.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def hue_shift(img, angle):
    """Hue rotation by ``angle`` (radians) in YIQ space.

    :param img: (..., H, W, 3); angle: broadcastable to img[..., 0]
    """
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    i = 0.596 * r - 0.274 * g - 0.322 * b
    q = 0.211 * r - 0.523 * g + 0.312 * b
    c = torch.cos(angle)
    s = torch.sin(angle)
    i2 = c * i - s * q
    q2 = s * i + c * q
    r = y + 0.956 * i2 + 0.621 * q2
    g = y - 0.272 * i2 - 0.647 * q2
    b = y - 1.106 * i2 + 1.703 * q2
    return torch.stack([r, g, b], -1)


def color_jitter(img, brightness, contrast, saturation, hue):
    """Colour jitter with drawn factors.

    :param img: (N, H, W, 3) in [0, 1]
    :param brightness, contrast, saturation: (N,) factors around 1
    :param hue: (N,) hue rotation in radians
    """
    def per_image(v):
        return v.reshape(-1, 1, 1, 1).to(img.dtype)
    img = img * per_image(brightness)
    mean = torch.mean(img, dim=(-3, -2, -1), keepdim=True)
    img = (img - mean) * per_image(contrast) + mean
    gray = torch.mean(img, dim=-1, keepdim=True)
    img = (img - gray) * per_image(saturation) + gray
    img = hue_shift(img, hue.reshape(-1, 1, 1).to(img.dtype))
    return torch.clamp(img, 0.0, 1.0)


def draw_color_jitter(gen, n: int, brightness=0.05, contrast=0.05,
                      saturation=0.05, hue=0.05, device=None):
    """(brightness, contrast, saturation, hue) factors for ``n`` images:
    1 + U(-x, x) for the first three, U(-hue, hue) * 2 pi for the hue."""
    u = torch.rand((4, n), generator=gen) * 2 - 1
    b = 1.0 + u[0] * brightness
    c = 1.0 + u[1] * contrast
    s = 1.0 + u[2] * saturation
    h = u[3] * hue * 2 * math.pi
    return tuple(t.to(device) for t in (b, c, s, h))


def motion_blur_kernel(kernel_size: int, angle_deg, direction):
    """Oriented line kernels (kornia RandomMotionBlur semantics: angle in
    degrees, direction biases the kernel's asymmetry).

    :param angle_deg, direction: (N,) drawn values
    :return: (N, k, k) float32, each summing to 1
    """
    ang = (angle_deg * math.pi / 180.0)[:, None, None]
    dirn = direction[:, None, None]
    k = kernel_size
    r = (k - 1) / 2.0
    steps = torch.arange(k, dtype=torch.float32, device=ang.device) - r
    ys, xs = torch.meshgrid(steps, steps, indexing="ij")
    dist = torch.abs(-torch.sin(ang) * xs + torch.cos(ang) * ys)
    along = torch.cos(ang) * xs + torch.sin(ang) * ys
    on_line = torch.clamp(1.0 - dist, min=0.0)
    weights = on_line * (1.0 + dirn * along / max(r, 1.0))
    weights = torch.clamp(weights, min=0.0)
    return weights / torch.clamp(weights.sum((1, 2), keepdim=True), min=1e-8)


def draw_motion_blur(gen, n: int, angle_deg=70.0, direction=0.5,
                     device=None):
    """(angle in degrees, direction) for ``n`` images, U(-a, a) each."""
    u = torch.rand((2, n), generator=gen) * 2 - 1
    return (u[0] * angle_deg).to(device), (u[1] * direction).to(device)


def motion_blur(img, kern):
    """Blur each image with its kernel (zero padding, same size).

    :param img: (N, H, W, 3); kern: (N, k, k)
    """
    N, H, W, C = img.shape
    k = kern.shape[-1]
    x = img.permute(0, 3, 1, 2).reshape(1, N * C, H, W)
    weight = kern.to(img.dtype)[:, None].expand(N, C, k, k).reshape(
        N * C, 1, k, k)
    out = F.conv2d(x, weight, padding=k // 2, groups=N * C)
    return out.reshape(N, C, H, W).permute(0, 2, 3, 1)


def augment_batch(gen, batch: Dict, same_on_views: bool = False,
                  any_aug: bool = True,
                  color_jitter_params: Tuple = (0.05, 0.05, 0.05, 0.05),
                  motion_blur_params: Tuple = (11, 70.0, 0.5)):
    """:param batch: dict with 'image' (B, V, 3, H, W) on any device;
    returns a copy with augmented images (other keys untouched). ``gen`` is
    a CPU ``torch.Generator``: the factors are drawn on the host and moved
    to the images' device."""
    if not any_aug:
        return batch
    image = batch["image"]
    B, V = image.shape[:2]
    dev = image.device
    n = B if same_on_views else B * V
    cj = draw_color_jitter(gen, n, *color_jitter_params, device=dev)
    ksize, angle, direction = motion_blur_params
    ang, dirn = draw_motion_blur(gen, n, angle, direction, device=dev)
    if same_on_views:
        cj = tuple(t.repeat_interleave(V) for t in cj)
        ang, dirn = ang.repeat_interleave(V), dirn.repeat_interleave(V)
    img = image.permute(0, 1, 3, 4, 2).reshape(B * V, *image.shape[3:],
                                                image.shape[2])
    img = color_jitter(img, *cj)
    img = motion_blur(img, motion_blur_kernel(int(ksize), ang, dirn))
    out = img.reshape(B, V, *img.shape[1:]).permute(0, 1, 4, 2, 3)
    return {**batch, "image": out.contiguous()}
