"""Zero-padded bilinear sampling (grid_sample semantics) in pixel
coordinates.

Port of ``tandem_tpu/ops/grid_sample.py``. Matches
torch.nn.functional.grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=True) in pixel coordinates, which the reference plane-sweep
warp depends on (cva_mvsnet/models/module.py:782-789, 871-873). The sample
is one launch of the kernel of ``ops/bilinear_sample.py``
(``csrc/bilinear_sample.cu``), which reads each sample's four corners
straight from the NHWC image, zero outside it. The JAX package's
packed-corner table (``ops/bilinear_sample.pack_corners``: the four corners
of every cell side by side in one row of a 1-pixel zero-padded copy of the
image) is kept for kernel P3's probe contract and for the plain version.
"""

from __future__ import annotations

from .bilinear_sample import bilinear_sample


def bilinear_sample_pixel(img, x, y):
    """Sample ``img`` (B, H, W, C) at pixel coordinates x, y (B, N) with
    bilinear interpolation and per-corner zero padding outside
    [0, W-1] x [0, H-1]. Returns (B, N, C)."""
    return bilinear_sample(img.contiguous(), x.float().contiguous(),
                           y.float().contiguous())


def grid_sample_bilinear(img, grid):
    """torch-compatible grid_sample.

    :param img: (B, H, W, C)
    :param grid: (B, Ho, Wo, 2) normalized coords in [-1, 1], align_corners
        convention: -1 -> pixel 0, +1 -> pixel (W-1) (module.py:782-789)
    :return: (B, Ho, Wo, C)
    """
    B, H, W, C = img.shape
    _, Ho, Wo, _ = grid.shape
    x = (grid[..., 0].float() + 1.0) * (0.5 * (W - 1))
    y = (grid[..., 1].float() + 1.0) * (0.5 * (H - 1))
    out = bilinear_sample_pixel(img, x.reshape(B, -1), y.reshape(B, -1))
    return out.reshape(B, Ho, Wo, C)
