"""Kernel P5: the bilinear index chain of the plane-sweep sample.

``bilinear_index`` launches the hand-written CUDA kernel
``csrc/bilinear_index.cu`` (the port of ``experiments/bench_idxchain.py``
``make_pallas``, i.e. the chain of ``tandem_tpu/ops/warp.py:124-140``) for
CUDA tensors and uses ``bilinear_index_plain`` for CPU tensors. There is no
fallback: a CUDA tensor goes through the kernel or the call raises.

For each position (x, y) it returns the row of the packed-corner table
(``ops/bilinear_sample.pack_corners``) that holds the four corners of the floor
cell, and the four corner weights in the order (y, x), (y, x+1), (y+1, x),
(y+1, x+1). A cell whose floor lies beyond the 1-pixel zero pad, or whose
keep flag is False, gets four zero weights.
"""

from __future__ import annotations

import torch

WEIGHT_DTYPES = (torch.float32, torch.bfloat16)


def table_rows(H: int, W: int) -> int:
    """Rows of one image's packed-corner table."""
    return (H + 1) * (W + 1)


def bilinear_index_plain(px, py, H: int, W: int, keep=None, batches: int = 1,
                         dtype=torch.float32):
    """The JAX chain in its order: floor, x - x0, 1 - w, the in-bounds test,
    (wx0 * wy0) * ins, one cast to ``dtype``.

    :return: rows (int32, px's shape), weights (4, *px.shape) ``dtype``
    """
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx1 = px - x0
    wy1 = py - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    inside = (x0 >= -1) & (x0 <= W - 1) & (y0 >= -1) & (y0 <= H - 1)
    if keep is not None:
        inside = inside & keep
    ins = inside.to(torch.float32)
    weights = torch.stack([wx0 * wy0 * ins, wx1 * wy0 * ins,
                           wx0 * wy1 * ins, wx1 * wy1 * ins]).to(dtype)
    xi = torch.clamp(x0, -1, W - 1).to(torch.int32) + 1
    yi = torch.clamp(y0, -1, H - 1).to(torch.int32) + 1
    offs = torch.arange(batches, dtype=torch.int32, device=px.device) \
        * table_rows(H, W)
    rows = (yi * (W + 1) + xi).reshape(batches, -1) + offs[:, None]
    return rows.reshape(px.shape), weights


def bilinear_index(px, py, H: int, W: int, keep=None, batches: int = 1,
                   dtype=torch.float32):
    """Packed-corner rows and corner weights of pixel positions.

    :param px, py: float32 positions, same shape, contiguous
    :param H, W: the sampled image's size
    :param keep: optional bool mask of px's shape (False = zero weights)
    :param batches: px's elements form this many equal consecutive blocks;
        block b indexes image b of a batched table, so its rows are offset
        by b * (H + 1) * (W + 1)
    :param dtype: weight type, float32 or bfloat16
    :return: rows (int32, px's shape), weights (4, *px.shape) ``dtype``
    """
    if px.shape != py.shape or px.dtype != torch.float32 \
            or py.dtype != torch.float32:
        raise ValueError("bilinear_index: px, py must be float32 of one "
                         f"shape, got {px.dtype} {tuple(px.shape)} and "
                         f"{py.dtype} {tuple(py.shape)}")
    if keep is not None and (keep.dtype != torch.bool
                             or keep.shape != px.shape):
        raise ValueError("bilinear_index: keep must be bool of px's shape")
    if dtype not in WEIGHT_DTYPES:
        raise ValueError(f"bilinear_index: weight dtype {dtype} not in "
                         f"{WEIGHT_DTYPES}")
    if H < 1 or W < 1 or batches < 1 or px.numel() % batches:
        raise ValueError(f"bilinear_index: bad H={H} W={W} "
                         f"batches={batches} for {px.numel()} samples")
    if batches * table_rows(H, W) >= 2 ** 31:
        raise ValueError("bilinear_index: table rows overflow int32")
    if px.device.type == "cpu":
        return bilinear_index_plain(px, py, H, W, keep, batches, dtype)
    if px.device.type != "cuda":
        raise ValueError(f"bilinear_index: unsupported device {px.device}")
    tensors = (px, py) if keep is None else (px, py, keep)
    if not all(t.is_contiguous() and t.device == px.device for t in tensors):
        raise ValueError("bilinear_index: inputs must be contiguous on one "
                         "device")
    from ._build import launch

    n = px.numel()
    rows = torch.empty(px.shape, dtype=torch.int32, device=px.device)
    weights = torch.empty((4, *px.shape), dtype=dtype, device=px.device)
    if n == 0:
        return rows, weights
    launch("tandem_bilinear_index", px.device, px.data_ptr(), py.data_ptr(),
           None if keep is None else keep.data_ptr(), n, n // batches, H, W,
           rows.data_ptr(), weights.data_ptr(), int(dtype == torch.bfloat16))
    bilinear_index.launches += 1
    return rows, weights


bilinear_index.launches = 0
