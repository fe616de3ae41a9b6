"""Kernel P3: the packed-corner gather and 4-weight blend of the
plane-sweep sample.

``corner_blend`` launches the hand-written CUDA kernel
``csrc/corner_blend.cu`` (the port of ``experiments/pallas_gather_probe.py``
``make_pallas_fused``, i.e. the ``_plain`` sample of
``tandem_tpu/ops/warp.py:147-157``) for CUDA tensors and uses
``corner_blend_plain`` for CPU tensors. There is no fallback: a CUDA tensor
goes through the kernel or the call raises.

out[i] = ((g00 w00 + g10 w10) + g01 w01) + g11 w11, with g the four C-wide
corners of table row rows[i], summed in float32 and rounded once to the
table's type.
"""

from __future__ import annotations

import torch

DTYPES = (torch.float32, torch.bfloat16)


def corner_blend_plain(table, rows, weights):
    """Upcast, blend in the kernel's order, cast once.

    :param table: (M, 4C); rows: (N,) int; weights: (4, N)
    :return: (N, C) of table's dtype
    """
    C = table.shape[1] // 4
    g = table[rows.long()].float()
    w = weights.float()
    out = g[:, 0:C] * w[0, :, None]
    out = out + g[:, C:2 * C] * w[1, :, None]
    out = out + g[:, 2 * C:3 * C] * w[2, :, None]
    out = out + g[:, 3 * C:4 * C] * w[3, :, None]
    return out.to(table.dtype)


def _vec(C: int, elem: int, *ptrs) -> int:
    """Channels per thread: the widest of 16 bytes down that divides C and
    keeps every vector access aligned."""
    vec = 16 // elem
    while vec > 1 and (C % vec or any(p % (vec * elem) for p in ptrs)):
        vec //= 2
    return vec


def corner_blend(table, rows, weights):
    """Bilinear sample from a packed-corner table.

    :param table: (M, 4C) float32 or bfloat16, contiguous
    :param rows: (N,) int32 table rows, contiguous (``bilinear_index``)
    :param weights: (4, N) of table's dtype, contiguous
    :return: (N, C) of table's dtype
    """
    if table.dim() != 2 or table.shape[1] % 4 or table.dtype not in DTYPES:
        raise ValueError("corner_blend: table must be (M, 4C) float32 or "
                         f"bfloat16, got {table.dtype} {tuple(table.shape)}")
    if rows.dim() != 1 or rows.dtype != torch.int32:
        raise ValueError(f"corner_blend: rows must be (N,) int32, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if weights.shape != (4, rows.shape[0]) or weights.dtype != table.dtype:
        raise ValueError("corner_blend: weights must be (4, N) of the "
                         f"table's dtype, got {weights.dtype} "
                         f"{tuple(weights.shape)}")
    if table.device.type == "cpu":
        return corner_blend_plain(table, rows, weights)
    if table.device.type != "cuda":
        raise ValueError(f"corner_blend: unsupported device {table.device}")
    if not all(t.is_contiguous() and t.device == table.device
               for t in (table, rows, weights)):
        raise ValueError("corner_blend: inputs must be contiguous on one "
                         "device")
    from ._build import launch

    M, C4 = table.shape
    C, N = C4 // 4, rows.shape[0]
    out = torch.empty((N, C), dtype=table.dtype, device=table.device)
    if N == 0 or C == 0:
        return out
    vec = _vec(C, table.element_size(), table.data_ptr(), out.data_ptr())
    launch("tandem_corner_blend", table.device, table.data_ptr(),
           rows.data_ptr(), weights.data_ptr(), N, M, C, vec,
           int(table.dtype == torch.bfloat16), out.data_ptr())
    corner_blend.launches += 1
    return out


corner_blend.launches = 0
