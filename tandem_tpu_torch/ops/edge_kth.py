"""Kernel K1 and the edge filter around it.

``edge_filter`` is the whole depth edge filter as one op: per pixel the
15th smallest |difference| over the 5x5 window (K1), per image the k-th
smallest of those values as the threshold, the mask ``edge > threshold``,
and depth and confidence zeroed under the mask. For CUDA tensors it
launches ``csrc/edge_kth.cu`` (the port of
``tandem_tpu/ops/pallas_kernels.py`` ``edge_kth_value_pallas``, with the
threshold as an exact radix select on the card): one memset and four
kernels in one C call, no host read; the C call reports the kernels it
launched, which ``edge_filter.launches`` adds up. For CPU tensors it runs
``edge_filter_plain``. ``edge_kth_value`` is K1 alone (the select pass,
without its histogram).
There is no fallback: a CUDA tensor goes through the kernel or the call
raises.

The model's filter is the ``torch.library`` custom op
``tandem::edge_filter(depth, discard_percentage, conf)``: it turns the
percentage into the ranks itself (``discard_ranks``) and runs
``edge_filter_plain`` on the CPU and the C call on the card, so
``torch.export`` keeps it as one node that dispatches by device when the
program runs.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

WINDOW = 5
K_RANK = WINDOW * (WINDOW // 2 + 1)  # 15 of 25 (module.py:1338-1339)
# The radix select's digits, top first, of the 31 key bits below the sign.
RADIX_BITS = (11, 11, 9)
MAX_BATCH = 64               # images a call (csrc/edge_kth.cu kMaxBatch)
# Scratch words an image (kScratch): the three histograms and the state,
# padded to 128 bytes; the edge values follow the B images' words.
_SCRATCH_WORDS = sum(1 << b for b in RADIX_BITS) + 32
KERNELS_PER_CALL = 4         # and a memset of the histograms
# csrc/edge_kth.cu FilterArgs: 7 pointers, B, H, W, padding, the ranks.
_FILTER_ARGS = struct.Struct(f"<7Q4i{MAX_BATCH}I")


class EdgeFiltered(NamedTuple):
    depth: torch.Tensor                 # (B, H, W): 0 where mask
    conf: Optional[torch.Tensor]        # (B, H, W): 0 where mask, or None
    mask: torch.Tensor                  # (B, H, W) bool: True = discarded
    threshold: torch.Tensor             # (B,) float32: the k-th edge value


def edge_kth_plain(depth):
    """Unfold + sort form of ``edge_kth_value_xla``.

    :param depth: (B, H, W) float32 -> (B, H, W) float32: the K_RANK-th
        smallest |d(y+dy, x+dx) - d(y, x)| over the zero-padded window."""
    B, H, W = depth.shape
    w2 = WINDOW // 2
    padded = F.pad(depth, (w2, w2, w2, w2))
    shifts = torch.stack([padded[:, dy:dy + H, dx:dx + W]
                          for dy in range(WINDOW) for dx in range(WINDOW)], -1)
    edge = (shifts - depth[..., None]).abs()
    return torch.sort(edge, dim=-1).values[..., K_RANK - 1]


def radix_select_plain(values, ranks: Sequence[int]):
    """The kernel's threshold select in torch ops: per row the ranks[b]-th
    smallest (0-indexed, == sort(row)[k]) of non-negative float32 values,
    found digit by digit on their bit patterns (which order as the values
    do), with a bincount a digit and the rank left inside the chosen bin.

    :param values: (B, N) float32, >= +0
    :return: (B,) float32"""
    keys = values.contiguous().view(torch.int32).to(torch.int64)
    out = []
    for row, rank in zip(keys, ranks):
        prefix, rank, shift = 0, int(rank), 31
        for bits in RADIX_BITS:
            shift -= bits
            inside = row[(row >> (shift + bits)) == prefix]
            counts = torch.bincount((inside >> shift) & ((1 << bits) - 1),
                                    minlength=1 << bits)
            before = torch.cumsum(counts, 0) - counts
            digit = int(torch.searchsorted(before + counts, rank,
                                           right=True))
            rank -= int(before[digit])
            prefix = (prefix << bits) | digit
        out.append(prefix)
    return torch.tensor(out, dtype=torch.int32).view(torch.float32)


def _where_masked(mask, x):
    return None if x is None else torch.where(mask, torch.zeros_like(x), x)


def edge_filter_plain(depth, ranks: Sequence[int], conf=None) -> EdgeFiltered:
    """``edge_kth_plain``, ``radix_select_plain`` and the wheres.

    :param depth: (B, H, W) float32; ranks: B ints in [0, H*W); conf: like
        depth, or None"""
    B = depth.shape[0]
    edge = edge_kth_plain(depth)
    thres = radix_select_plain(edge.reshape(B, -1), ranks).to(depth.device)
    mask = edge > thres[:, None, None]
    return EdgeFiltered(_where_masked(mask, depth), _where_masked(mask, conf),
                        mask, thres)


def _check(name: str, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device.type not in ("cpu", "cuda") or t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device}, expected all on "
                             f"one CPU or CUDA device")
        if t.dtype != torch.float32 or t.dim() != 3:
            raise ValueError(f"{name}: expected (B, H, W) float32 tensors, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.shape != tensors[0].shape:
            raise ValueError(f"{name}: shapes {tuple(t.shape)} and "
                             f"{tuple(tensors[0].shape)} differ")
        if t.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def edge_kth_value(depth):
    """K1 alone. :param depth: (B, H, W) float32 contiguous -> (B, H, W)
    float32."""
    _check("edge_kth_value", depth)
    if depth.device.type == "cpu":
        return edge_kth_plain(depth)
    from ._build import launch

    B, H, W = depth.shape
    out = torch.empty_like(depth)
    if depth.numel() == 0:
        return out
    launch("tandem_edge_kth", depth.device, depth.data_ptr(), out.data_ptr(),
           B, H, W)
    edge_kth_value.launches += 1
    return out


def _filter_call(depth, ranks: Sequence[int], conf):
    """The outputs and scratch of one ``tandem_edge_filter`` call, and its
    packed argument block. The outputs own only their own memory: the
    histograms, the state and the edge values share the scratch, which is
    freed (stream-ordered) when the caller drops it.

    :return: (argument block, EdgeFiltered outputs, scratch)"""
    B, H, W = depth.shape
    dev = depth.device
    out = EdgeFiltered(
        torch.empty_like(depth),
        None if conf is None else torch.empty_like(conf),
        torch.empty((B, H, W), dtype=torch.bool, device=dev),
        torch.empty((B,), dtype=torch.float32, device=dev))
    scratch = torch.empty(B * (_SCRATCH_WORDS + H * W), dtype=torch.int32,
                          device=dev)
    args = _FILTER_ARGS.pack(
        depth.data_ptr(), 0 if conf is None else conf.data_ptr(),
        out.depth.data_ptr(), 0 if conf is None else out.conf.data_ptr(),
        out.mask.data_ptr(), out.threshold.data_ptr(), scratch.data_ptr(),
        B, H, W, 0, *ranks, *([0] * (MAX_BATCH - B)))
    return args, out, scratch


def edge_filter(depth, ranks: Sequence[int], conf=None) -> EdgeFiltered:
    """The edge filter: mask = K1(depth) > its ranks[b]-th smallest value
    (0-indexed), depth and ``conf`` zeroed under the mask.

    :param depth: (B, H, W) float32, contiguous on the card
    :param ranks: B host ints in [0, H*W) (``discard_ranks``)
    :param conf: None or like depth, on depth's device
    :return: EdgeFiltered(depth, conf, mask, threshold)"""
    _check("edge_filter", depth, *(() if conf is None else (conf,)))
    B, H, W = depth.shape
    ranks = [int(k) for k in ranks]
    if len(ranks) != B or not all(0 <= k < H * W for k in ranks):
        raise ValueError(f"edge_filter: need {B} ranks in [0, {H * W}), got "
                         f"{ranks}")
    if depth.device.type == "cpu":
        return edge_filter_plain(depth, ranks, conf)
    return _edge_filter_cuda(depth, ranks, conf)


def _edge_filter_cuda(depth, ranks: List[int], conf) -> EdgeFiltered:
    """The one C call (the inputs checked by the caller)."""
    B = depth.shape[0]
    if B > MAX_BATCH:
        raise ValueError(f"edge_filter: at most {MAX_BATCH} images a call, "
                         f"got {B}")
    from ._build import launch

    args, out, _ = _filter_call(depth, ranks, conf)
    launched = ctypes.c_int(0)
    try:
        launch("tandem_edge_filter", depth.device, args,
               ctypes.byref(launched))
    finally:
        edge_filter.launches += launched.value
    edge_filter.calls += 1
    return out


def discard_ranks(discard_percentage, hw: int) -> List[int]:
    """Threshold rank per image, in float32 exactly as the JAX package
    computes it (so the rank never shifts by one): trunc(H*W*(100-p)/100)
    clipped to [0, H*W-1]. Host ints: a CPU tensor is read without a device
    sync, a CUDA tensor is copied to the host with one."""
    p = discard_percentage.detach().to("cpu", torch.float32)
    cutoff = (hw * (100.0 - p) / 100.0).to(torch.int32)
    return torch.clamp(cutoff, 0, hw - 1).tolist()


FilterOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check_op(depth, discard_percentage, conf):
    _check("edge_filter", depth, *(() if conf is None else (conf,)))
    if discard_percentage.shape != depth.shape[:1]:
        raise ValueError(f"edge_filter: want a ({depth.shape[0]},) discard "
                         f"percentage, got {tuple(discard_percentage.shape)}")


def _op_outputs(out: EdgeFiltered, depth) -> FilterOut:
    """The op's four tensors: an absent confidence is an empty tensor."""
    conf = depth.new_empty((0,)) if out.conf is None else out.conf
    return out.depth, conf, out.mask, out.threshold


@torch.library.custom_op("tandem::edge_filter", mutates_args=(),
                         device_types="cpu")
def _edge_filter_op(depth: torch.Tensor, discard_percentage: torch.Tensor,
                    conf: Optional[torch.Tensor]) -> FilterOut:
    """The op on the CPU: ``edge_filter_plain``."""
    _check_op(depth, discard_percentage, conf)
    ranks = discard_ranks(discard_percentage, depth.shape[1] * depth.shape[2])
    return _op_outputs(edge_filter_plain(depth, ranks, conf), depth)


@_edge_filter_op.register_kernel("cuda")
def _(depth, discard_percentage, conf):
    """The op on the card: the one C call. ``discard_percentage`` may lie
    on the CPU (read without a device sync) or on the card (one sync)."""
    _check_op(depth, discard_percentage, conf)
    ranks = discard_ranks(discard_percentage, depth.shape[1] * depth.shape[2])
    return _op_outputs(_edge_filter_cuda(depth, ranks, conf), depth)


@_edge_filter_op.register_fake
def _(depth, discard_percentage, conf):
    _check_op(depth, discard_percentage, conf)
    return (torch.empty_like(depth),
            depth.new_empty((0,)) if conf is None else torch.empty_like(conf),
            torch.empty_like(depth, dtype=torch.bool),
            depth.new_empty(depth.shape[:1]))


edge_kth_value.launches = 0
edge_filter.launches = 0
edge_filter.calls = 0
