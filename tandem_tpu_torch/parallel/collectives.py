"""Collective-volume accounting, counted where the sums are issued.

Port of ``tandem_tpu/parallel/collectives.py``, which parses the
``stablehlo.all_reduce`` payloads of a lowered program. The port has no
lowered program, so every cross-device or cross-rank sum it issues goes
through this module (``device_sum`` for the view shards of one process,
``all_reduce_sum`` for the ranks of a process group), and each sum's
payload is noted, as (tensor type, bytes), in every recording open at the
time (``record``). The tensor type is written as StableHLO writes it
(``1x120x160x32xf32``; a scalar is ``f32``), so a recording compares entry
by entry with ``all_reduce_payloads`` of the JAX program.

From the per-sum payload S on an n-way ring, the standard all-reduce model
gives 2*S*(n-1)/n bytes through each card's links (reduce-scatter and
all-gather halves): ``link_bytes_per_card``, the counterpart of
``ici_bytes_per_chip``. One card has no links between its shards: the
number is the traffic the same sums would move across n cards.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "i64": 8, "ui64": 8, "i32": 4, "ui32": 4, "i16": 2, "ui16": 2,
    "i8": 1, "ui8": 1, "i1": 1,
}

_TORCH_TYPES = {torch.float64: "f64", torch.float32: "f32",
                torch.bfloat16: "bf16", torch.float16: "f16",
                torch.int64: "i64", torch.int32: "i32", torch.int16: "i16",
                torch.int8: "i8", torch.uint8: "ui8", torch.bool: "i1"}


def _tensor_bytes(type_str: str) -> int:
    parts = type_str.split("x")
    dtype = parts[-1]
    dims = [int(p) for p in parts[:-1]] or [1]
    size = _DTYPE_BYTES.get(dtype)
    assert size is not None, f"unknown element type in tensor<{type_str}>"
    n = 1
    for d in dims:
        n *= d
    return n * size


def tensor_type(t: torch.Tensor) -> str:
    """A tensor's type as StableHLO writes it: ``2x3xf32``, ``f32``."""
    return "x".join([*(str(d) for d in t.shape), _TORCH_TYPES[t.dtype]])


_OPEN: List[List[Tuple[str, int]]] = []


@contextlib.contextmanager
def record() -> Iterator[List[Tuple[str, int]]]:
    """The payloads, (tensor type, bytes), of every sum issued inside the
    ``with`` block."""
    payloads: List[Tuple[str, int]] = []
    _OPEN.append(payloads)
    try:
        yield payloads
    finally:
        _OPEN.remove(payloads)


def _note(t: torch.Tensor) -> None:
    entry = (tensor_type(t), _tensor_bytes(tensor_type(t)))
    for payloads in _OPEN:
        payloads.append(entry)


def in_group() -> bool:
    """Whether a default process group is open (data-parallel ranks)."""
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized())


def device_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The sum of one tensor a shard, added in shard order on the first
    shard's device (a psum over the shards of one process)."""
    _note(parts[0])
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(out.device)
    return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks of the default process group, in place."""
    _note(t)
    torch.distributed.all_reduce(t)
    return t


def link_bytes_per_card(payloads: Sequence[Tuple[str, int]],
                        n_devices: int) -> Dict[str, float]:
    """One execution's traffic: ``payload_bytes`` (the sum of the payloads
    S), ``link_bytes`` (ring all-reduce bytes through each card's links,
    the sum of 2*S*(n-1)/n) and ``n_collectives``."""
    total = float(sum(b for _, b in payloads))
    return {
        "payload_bytes": total,
        "link_bytes": 2.0 * total * (n_devices - 1) / max(n_devices, 1),
        "n_collectives": len(payloads),
    }
