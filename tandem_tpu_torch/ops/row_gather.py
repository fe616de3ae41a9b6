"""Kernel for P1, P2 and P4: the row gather ``out[i, :] = table[idx[i], :]``.

``row_gather`` launches the hand-written CUDA kernel ``csrc/row_gather.cu``
(the port of ``experiments/pallas_gather_probe.py`` ``make_pallas_sublane``
and ``make_pallas_take`` and ``experiments/pallas_shuffle_probe.py``
``make_shuffle``, three Mosaic lowerings of one function) for CUDA tensors
and uses ``row_gather_plain`` for CPU tensors. There is no fallback: a CUDA
tensor goes through the kernel or the call raises.
"""

from __future__ import annotations

import torch

DTYPES = (torch.float32, torch.bfloat16)


def row_gather_plain(table, idx):
    """:param table: (M, R); idx: (N,) int -> (N, R)"""
    return table[idx.long()]


def _vec_bytes(row_bytes: int, *ptrs) -> int:
    """The widest word of 16 bytes down that divides the row and keeps
    every access aligned."""
    vec = 16
    while vec > 1 and (row_bytes % vec or any(p % vec for p in ptrs)):
        vec //= 2
    return vec


def row_gather(table, idx):
    """Gather whole rows.

    :param table: (M, R) float32 or bfloat16, contiguous
    :param idx: (N,) int32 row indices, contiguous
    :return: (N, R) of table's dtype
    """
    if table.dim() != 2 or table.dtype not in DTYPES:
        raise ValueError("row_gather: table must be (M, R) float32 or "
                         f"bfloat16, got {table.dtype} {tuple(table.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"row_gather: idx must be (N,) int32, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"row_gather: unsupported device {table.device}")
    if not all(t.is_contiguous() and t.device == table.device
               for t in (table, idx)):
        raise ValueError("row_gather: inputs must be contiguous on one "
                         "device")
    from ._build import launch

    M, R = table.shape
    N = idx.shape[0]
    out = torch.empty((N, R), dtype=table.dtype, device=table.device)
    row_bytes = R * table.element_size()
    if N == 0 or R == 0:
        return out
    launch("tandem_row_gather", table.device, table.data_ptr(),
           idx.data_ptr(), N, M, row_bytes,
           _vec_bytes(row_bytes, table.data_ptr(), out.data_ptr()),
           out.data_ptr())
    row_gather.launches += 1
    return out


row_gather.launches = 0
