"""The cost regulariser's decoder step in one launch.

``deconv_bn_relu_add(x, weight, inv, off, skip, stride)`` is CostRegNet's
eval decoder step (``models/layers.DeconvBnRelu`` with its skip):

    skip + relu(conv_transpose3d(x, weight, stride, padding=1,
                                 output_padding=stride - 1) * inv + off)

for a 3x3x3 kernel, stride 2 on H and W and 1 or 2 on D, with ``(inv,
off)`` the folded BatchNorm (``models/layers.fold_bn``). For CUDA tensors
it launches the hand-written kernel ``csrc/deconv3d.cu`` (one launch a
step, deterministic: each output voxel gathers its taps in a fixed order,
with no atomics); for CPU tensors it runs ``deconv_bn_relu_add_plain``.
There is no fallback: a CUDA tensor goes through the kernel or the call
raises.

``deconv_bn_relu_add_plain`` is the kernel's arithmetic in torch ops: the
same phase gather (``PHASE_TAPS``), the same tap order and the same
float32 accumulation in input channels ascending, and the eager epilogue
(rounded to the compute dtype, times inv, plus off, relu, plus the skip).
The kernel fuses each multiply-add (fmaf), the plain version rounds the
product and the sum, so the two agree to float32 rounding, not bit for
bit; the epilogue is the eager path's, rounding for rounding.

The op is the ``torch.library`` custom op ``tandem::deconv_bn_relu_add``
(CPU implementation the plain version, CUDA the kernel, a fake for
``torch.export``), so an exported program keeps each step as one node.
It is an inference step: no gradient.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from ._build import launch

DTYPES = (torch.float32, torch.bfloat16)
# A block of the kernel holds the weights of its 4 output channels for all
# input channels in 48 KB of shared memory: at most csrc/deconv3d.cu
# kMaxCin input channels (CostRegNet's widest step has 64).
MAX_CIN = 113
MAX_VALUES = 2 ** 31
# csrc/deconv3d.cu DeconvArgs: six pointers, nine int32s and the C
# struct's 4 bytes of tail padding (88 bytes).
_ARGS = struct.Struct("<6Q9i4x")

# An axis's gather by its stride (padding 1, output padding stride - 1):
# for each output phase p (output index stride * m + p), its taps in
# ascending k, each (k, input offset from m).
PHASE_TAPS = {2: (((1, 0),), ((0, 1), (2, 0))),
              1: (((0, 1), (1, 0), (2, -1)),)}


def output_shape(x_shape: Sequence[int], co: int, stride) -> tuple:
    N, _, D, H, W = x_shape
    return (N, co, stride[0] * D, stride[1] * H, stride[2] * W)


def deconv_plain(x, weight, stride):
    """conv_transpose3d(x, weight, stride, padding 1, output_padding
    stride - 1) by the kernel's phase gather: float32 sums over the input
    channels ascending, each channel's taps in ascending (kd, kh, kw)
    order.

    :param x: (N, Ci, D, H, W); weight: (Ci, Co, 3, 3, 3)
    :return: (N, Co, sd * D, sh * H, sw * W) float32
    """
    N, Ci, D, H, W = x.shape
    Co = weight.shape[1]
    xp = F.pad(x.float(), (1, 1, 1, 1, 1, 1))       # offsets -1 .. +1
    wf = weight.float()
    out = xp.new_empty(output_shape(x.shape, Co, stride))
    sd, sh, sw = stride
    for pd, taps_d in enumerate(PHASE_TAPS[sd]):
        for ph, taps_h in enumerate(PHASE_TAPS[sh]):
            for pw, taps_w in enumerate(PHASE_TAPS[sw]):
                acc = xp.new_zeros((N, Co, D, H, W))
                for ci in range(Ci):
                    for kd, od in taps_d:
                        for kh, oh in taps_h:
                            for kw, ow in taps_w:
                                xs = xp[:, ci, 1 + od:1 + od + D,
                                        1 + oh:1 + oh + H, 1 + ow:1 + ow + W]
                                acc = acc + xs[:, None] * wf[
                                    ci, :, kd, kh, kw].reshape(1, Co, 1, 1, 1)
                out[:, :, pd::sd, ph::sh, pw::sw] = acc
    return out


def deconv_bn_relu_add_plain(x, weight, inv, off, skip=None, stride=(2, 2, 2),
                             relu: bool = True):
    """The decoder step in torch ops: ``deconv_plain`` rounded to x's
    dtype, then the eager epilogue in that dtype."""
    shape = (1, -1, 1, 1, 1)
    y = deconv_plain(x, weight, stride).to(x.dtype)
    y = y * inv.reshape(shape) + off.reshape(shape)
    if relu:
        y = F.relu(y)
    return y if skip is None else skip + y


def deconv_bn_relu_add(x, weight, inv, off, skip=None, stride=(2, 2, 2),
                       relu: bool = True):
    """The decoder step: one launch on the card, the plain version on the
    CPU.

    :param x: (N, Ci, D, H, W) float32 or bfloat16, contiguous
    :param weight: (Ci, Co, 3, 3, 3) ConvTranspose3d weight in x's dtype
    :param inv, off: (Co,) folded BatchNorm in x's dtype
    :param skip: None or (N, Co, sd * D, 2 H, 2 W) in x's dtype
    :param stride: (sd, 2, 2) with sd 1 or 2
    :return: (N, Co, sd * D, 2 H, 2 W) in x's dtype
    """
    return torch.ops.tandem.deconv_bn_relu_add(x, weight, inv, off, skip,
                                               [int(s) for s in stride],
                                               bool(relu))


def _check(x, weight, inv, off, skip, stride):
    """Types, shapes, layouts and devices both paths take; raise
    ValueError. Lean: it runs on every launch."""
    if x.dim() != 5 or x.dtype not in DTYPES:
        raise ValueError(f"deconv_bn_relu_add: x must be (N, C, D, H, W) "
                         f"float32 or bfloat16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if len(stride) != 3 or stride[1:] != [2, 2] or stride[0] not in (1, 2):
        raise ValueError(f"deconv_bn_relu_add: stride must be (1 or 2, 2, "
                         f"2), got {tuple(stride)}")
    Ci = x.shape[1]
    if weight.dim() != 5 or weight.shape[0] != Ci \
            or weight.shape[2:] != (3, 3, 3):
        raise ValueError(f"deconv_bn_relu_add: weight must be ({Ci}, Co, 3, "
                         f"3, 3), got {tuple(weight.shape)}")
    Co = weight.shape[1]
    tensors = [x, weight, inv, off] + ([] if skip is None else [skip])
    if inv.shape != (Co,) or off.shape != (Co,) or (
            skip is not None
            and skip.shape != output_shape(x.shape, Co, stride)):
        raise ValueError(f"deconv_bn_relu_add: want inv, off ({Co},) and "
                         f"skip {output_shape(x.shape, Co, stride)}, got "
                         f"{tuple(inv.shape)} {tuple(off.shape)} "
                         f"{None if skip is None else tuple(skip.shape)}")
    cuda, index = x.is_cuda, x.get_device()
    for t in tensors:
        if t.dtype != x.dtype:
            raise ValueError(f"deconv_bn_relu_add: every tensor must be "
                             f"{x.dtype}, got {t.dtype}")
        if not (t.is_cuda and t.get_device() == index if cuda else t.is_cpu):
            raise ValueError("deconv_bn_relu_add: inputs must share one cpu "
                             "or cuda device")
        if not t.is_contiguous():
            raise ValueError("deconv_bn_relu_add: inputs must be contiguous")


@torch.library.custom_op("tandem::deconv_bn_relu_add", mutates_args=(),
                         device_types="cpu")
def _deconv_op(x: torch.Tensor, weight: torch.Tensor, inv: torch.Tensor,
               off: torch.Tensor, skip: Optional[torch.Tensor],
               stride: List[int], relu: bool) -> torch.Tensor:
    """The op on the CPU: the plain version."""
    _check(x, weight, inv, off, skip, stride)
    return deconv_bn_relu_add_plain(x, weight, inv, off, skip, stride, relu)


@_deconv_op.register_kernel("cuda")
def _deconv_cuda(x, weight, inv, off, skip, stride, relu):
    """The op on the card: one launch of the kernel."""
    _check(x, weight, inv, off, skip, list(stride))
    N, Ci, D, H, W = x.shape
    Co = weight.shape[1]
    shape = output_shape(x.shape, Co, stride)
    if Ci > MAX_CIN or N > 65535 or x.numel() >= MAX_VALUES \
            or shape[1] * shape[2] * shape[3] * shape[4] >= MAX_VALUES:
        raise ValueError(f"deconv_bn_relu_add: {tuple(x.shape)} -> {shape} "
                         "exceeds the kernel's grid, offsets or shared "
                         "memory")
    if skip is not None and skip.data_ptr() % (2 * skip.element_size()):
        raise ValueError("deconv_bn_relu_add: the skip must be aligned to "
                         "two elements (the kernel reads W pairs)")
    out = x.new_empty(shape)
    if out.numel() == 0:
        return out
    launch("tandem_deconv_bn_relu_add", x.device, _ARGS.pack(
        x.data_ptr(), weight.data_ptr(), inv.data_ptr(), off.data_ptr(),
        0 if skip is None else skip.data_ptr(), out.data_ptr(),
        N, Ci, Co, D, H, W, stride[0], int(x.dtype == torch.bfloat16),
        int(relu)))
    deconv_bn_relu_add.launches += 1
    return out


@_deconv_op.register_fake
def _(x, weight, inv, off, skip, stride, relu):
    _check(x, weight, inv, off, skip, stride)
    return x.new_empty(output_shape(x.shape, weight.shape[1], stride))


deconv_bn_relu_add.launches = 0
