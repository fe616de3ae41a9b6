"""The plane-sweep sample in one launch: bilinear sampling of an NHWC image
straight from the image.

``warp_sample`` (plane sweep: the positions come from the ref->src matrix
and the depth hypotheses) and ``bilinear_sample`` (given positions) launch
the hand-written CUDA kernel ``csrc/bilinear_sample.cu`` for CUDA tensors
and use ``warp_sample_plain`` / ``bilinear_sample_plain`` for CPU tensors.
There is no fallback: a CUDA tensor goes through the kernel or the call
raises. The kernel takes the place, on the main path, of kernels P5
(``ops/bilinear_index.py``) and P3 (``ops/corner_blend.py``) around the
packed-corner table, and of the position math of ``ops/warp.py``.

Semantics: ``grid_sample`` bilinear with ``align_corners=True`` in pixel
coordinates and zero padding; corners outside the image read zero, and
dropped samples get zero weights. The plain versions chain the plain
pieces of that older path (the positions as ``ops/warp.py`` computed them,
``bilinear_index_plain``, ``pack_corners``, ``corner_blend_plain``), and the
kernel equals them bit for bit.

Custom ops: the plane sweep and its gradient are the ``torch.library``
custom ops ``tandem::warp_sample`` and ``tandem::warp_sample_grad``, whose
CPU implementations are the plain versions and whose CUDA implementations
launch the kernels; a fake implementation gives each output's shape and
dtype. The dispatcher picks the implementation by the tensors' device when
the op runs, so ``torch.export`` keeps each call as one node of the graph
and an exported program launches the kernels on the card.

Variance: ``warp_variance`` is the variance cost volume's step for one
source view (the cascade without view aggregation): the plane sweep's
samples x of the view added to the running sums of x and x * x in place,
or written by the first view; on the card one launch of the same source
(``tandem::warp_variance``, whose CPU implementation is
``warp_variance_plain``, the eager accumulation of ``warp_sample_plain``'s
volume and its square). The kernel rounds as the plain version does, so
the two are equal bit for bit. It is an inference step: no gradient.

Gradient: ``warp_sample`` is differentiable with respect to the image,
through the op's registered autograd formula on either device: the
backward is ``warp_sample_grad`` (on the card one launch of the
hand-written gradient kernel of the same source: the forward's positions,
weights and drop decisions; a thread sums a run of one pixel's planes on
one source cell in registers and adds each corner's sum with one float32
vector atomic; on the CPU ``warp_sample_grad_plain``), the float32 sums
then cast once to the image's dtype. No gradient flows to the matrix or
the depths (the JAX package's positions depend only on inputs and stopped
depths): the call raises if either requires one. The atomics add in an
order that changes from run to run, so the gradient on the card is not
bit-reproducible; the forward is.
"""

from __future__ import annotations

import functools
import struct

import torch
import torch.nn.functional as F

from ._build import launch
from .bilinear_index import bilinear_index_plain, table_rows
from .corner_blend import _vec, corner_blend_plain

DTYPES = (torch.float32, torch.bfloat16)
# The plane-sweep kernel's tiling: a block is 8 warps of 32 samples of
# one row, over SWEEP_ROWS_PER_BLOCK rows (1, 2, 4 or 8), and a warp walks
# 1, 2 or 4 consecutive depth planes of its samples (``sweep_tiling``).
SWEEP_ROWS_PER_BLOCK = 8
# The gradient kernel's block: 256 (pixel, channel vector) items of 4
# channels (fewer where grad_out's alignment asks), each walking
# consecutive planes (``grad_tiling``, which splits D into groups of no
# fewer than GRAD_MIN_PLANES).
GRAD_THREADS = 256
GRAD_MAX_VEC = 4
GRAD_MIN_PLANES = 4
# CUDA's grid limit on the kernel's plane axis, and the image size its
# 32-bit offsets and 16-bit cell coordinates take.
MAX_PLANES = 65535
MAX_SIDE = 65534
MAX_VALUES = 2 ** 31


def pack_corners(img):
    """(B, H, W, C) -> (B, H+1, W+1, 4C) zero-padded corner table.

    Row (y, x) holds [v(y,x), v(y,x+1), v(y+1,x), v(y+1,x+1)] of the padded
    image, so row (y0+1, x0+1) holds all four corners of the cell whose
    top-left is (y0, x0) in image coordinates, for y0, x0 in
    [-1, H-1] x [-1, W-1]."""
    p = F.pad(img, (0, 0, 1, 1, 1, 1))
    return torch.cat([p[:, :-1, :-1], p[:, :-1, 1:],
                      p[:, 1:, :-1], p[:, 1:, 1:]], -1)


def sweep_positions(ref_to_src, depth, H: int, W: int):
    """Source pixel positions of every reference pixel and depth
    hypothesis, in the JAX package's order (tandem_tpu/ops/warp.py:96-106).

    :param ref_to_src: (B, 3, 4) float32 ref pixel -> src pixel projection
    :param depth: (B, D, H, W) float32
    :return: px, py, z, each (B, D, H, W) float32
    """
    f32 = torch.float32
    gy, gx = torch.meshgrid(torch.arange(H, dtype=f32, device=depth.device),
                            torch.arange(W, dtype=f32, device=depth.device),
                            indexing="ij")

    def proj_component(i):
        # ref_to_src[i, :3] @ [x, y, 1] per pixel, then * depth + t_i
        dir_i = (ref_to_src[:, i, 0, None, None] * gx
                 + ref_to_src[:, i, 1, None, None] * gy
                 + ref_to_src[:, i, 2, None, None])        # (B, H, W)
        return dir_i[:, None] * depth + ref_to_src[:, i, 3, None, None, None]

    z = proj_component(2)
    z_safe = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return proj_component(0) / z_safe, proj_component(1) / z_safe, z


def bilinear_sample_plain(img, px, py, keep=None):
    """P5's and P3's plain versions around the packed-corner table.

    :param img: (B, H, W, C); px, py: float32 (B, ...); keep: bool of px's
        shape or None
    :return: (B, ..., C) of img's dtype
    """
    B, H, W, C = img.shape
    rows, weights = bilinear_index_plain(px, py, H, W, keep, B, img.dtype)
    table = pack_corners(img).reshape(B * table_rows(H, W), 4 * C)
    out = corner_blend_plain(table, rows.reshape(-1), weights.reshape(4, -1))
    return out.reshape(*px.shape, C)


def warp_sample_plain(img, ref_to_src, depth, min_depth_thres: float = 0.001):
    """The positions, then ``bilinear_sample_plain``; samples with
    z < min_depth_thres (behind the source camera) are dropped.

    :return: (B, D, H, W, C) of img's dtype
    """
    H, W = img.shape[1:3]
    px, py, z = sweep_positions(ref_to_src, depth, H, W)
    return bilinear_sample_plain(img, px, py, keep=~(z < min_depth_thres))


def warp_sample_grad_plain(grad_out, ref_to_src, depth,
                           min_depth_thres: float = 0.001,
                           acc_dtype=torch.float32):
    """The plain version of ``warp_sample_grad``: the forward's weights (of
    grad_out's dtype, as the forward rounds them), each sample's
    grad_out x weight added to its corners in ``acc_dtype`` (index_add_).

    :param grad_out: (B, D, H, W, C) float32 or bfloat16
    :return: (B, H, W, C) ``acc_dtype`` sums
    """
    B, D, H, W, C = grad_out.shape
    px, py, z = sweep_positions(ref_to_src, depth, H, W)
    rows, weights = bilinear_index_plain(px, py, H, W, ~(z < min_depth_thres),
                                         B, grad_out.dtype)
    # Table row r of image b = (yi, xi) holds the corners whose padded
    # image coordinates are (yi, xi), (yi, xi + 1), (yi + 1, xi),
    # (yi + 1, xi + 1).
    r = rows.long().reshape(B, -1) - (
        torch.arange(B, device=rows.device)[:, None] * table_rows(H, W))
    yi, xi = r // (W + 1), r % (W + 1)
    base = torch.arange(B, device=rows.device)[:, None] * ((H + 2) * (W + 2))
    g = grad_out.reshape(B, -1, C).to(acc_dtype)
    w = weights.reshape(4, B, -1).to(acc_dtype)
    acc = torch.zeros((B * (H + 2) * (W + 2), C), dtype=acc_dtype,
                      device=grad_out.device)
    for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        idx = (base + (yi + dy) * (W + 2) + xi + dx).reshape(-1)
        acc.index_add_(0, idx, (g * w[k][..., None]).reshape(-1, C))
    return acc.reshape(B, H + 2, W + 2, C)[:, 1:-1, 1:-1].contiguous()


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sweep_tiling(B: int, D: int, H: int, W: int, lanes: int,
                 sms: int) -> tuple:
    """(rows a block, planes a warp) of the plane-sweep kernel, for
    ``lanes`` = C / vec lanes a sample on a card of ``sms`` SMs.

    Several planes a warp hide the depth load's DRAM latency where a
    plane is a few rounds (lanes < 8), but cost blocks: they stay while
    the grid keeps 4 blocks an SM. Chosen from the settings timed on the
    H100 at the abl04 stages (CHANGES.md)."""
    rows = SWEEP_ROWS_PER_BLOCK
    if lanes < 8:
        tiles = B * -(-W // (256 // rows)) * -(-H // rows)
        for planes in (4, 2):
            if tiles * -(-D // planes) >= 4 * sms:
                return rows, planes
    return rows, 1


def grad_tiling(B: int, D: int, H: int, W: int, lanes: int,
                sms: int) -> int:
    """Planes a thread of the gradient kernel walks, for ``lanes`` = C / vec
    channel vectors a pixel on a card of ``sms`` SMs: all D where the grid
    keeps 4 blocks an SM (a run can then sum every plane of a pixel that
    lands in one source cell), else D halved until it does or reaches
    GRAD_MIN_PLANES."""
    blocks = B * -(-H * W * lanes // GRAD_THREADS)
    planes = D
    while planes > GRAD_MIN_PLANES and blocks * -(-D // planes) < 4 * sms:
        planes = max(-(-planes // 2), GRAD_MIN_PLANES)
    return planes


def _grad_vec(C: int, elem: int, ptr: int) -> int:
    """Channels a lane of the gradient kernel sums: 4 (one float4 of
    sums, 16 bytes of f32 or 8 of bf16 grad_out), fewer where C or
    grad_out's alignment asks."""
    return min(_vec(C, elem, ptr), GRAD_MAX_VEC)


def _too_large(H: int, W: int, C: int) -> bool:
    return max(H, W) > MAX_SIDE or (H + 1) * (W + 1) * C >= MAX_VALUES


@functools.cache
def _plan(B: int, D: int, H: int, W: int, C: int, elem: int, misalign: int,
          index: int) -> tuple:
    """(vec, rows a block, planes a warp) of a plane sweep whose image
    starts ``misalign`` bytes past a 16-byte boundary."""
    vec = _vec(C, elem, misalign)
    return (vec, *sweep_tiling(B, D, H, W, C // vec, _sm_count(index)))


# The layouts of SweepArgs, SampleArgs and GradArgs in
# csrc/bilinear_sample.cu: the pointers, the int64s, the int32s and
# floats, 80 bytes each.
_SWEEP_ARGS = struct.Struct("<4Q2q7if")
_SAMPLE_ARGS = struct.Struct("<5Q2q6i")
_GRAD_ARGS = struct.Struct("<4Q2q6ifi")
# VarianceArgs: SweepArgs (its out the running sum), then the sum of
# squares, first and a pad: 96 bytes.
_VARIANCE_ARGS = struct.Struct(_SWEEP_ARGS.format + "Qii")


def _check(name: str, img, floats, keep=None):
    """Types, layouts and devices both paths take; raise ValueError. Lean:
    it runs on every launch."""
    if img.dim() != 4 or img.dtype not in DTYPES:
        raise ValueError(f"{name}: img must be (B, H, W, C) float32 or "
                         f"bfloat16, got {img.dtype} {tuple(img.shape)}")
    for t in floats:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: positions, matrices and depths must "
                             f"be float32, got {t.dtype}")
    if keep is not None and keep.dtype != torch.bool:
        raise ValueError(f"{name}: keep must be bool, got {keep.dtype}")
    cuda, index = img.is_cuda, img.get_device()
    for t in (img, *floats) if keep is None else (img, *floats, keep):
        if not (t.is_cuda and t.get_device() == index if cuda else t.is_cpu):
            raise ValueError(f"{name}: inputs must share one cpu or cuda "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def warp_sample(img, ref_to_src, depth, min_depth_thres: float = 0.001):
    """Plane-sweep sample: ``img`` warped over the depth hypotheses;
    differentiable with respect to ``img`` (see the module's docstring).

    :param img: (B, H, W, C) float32 or bfloat16, contiguous (the source
        view's features)
    :param ref_to_src: (B, 3, 4) float32 ref pixel -> src pixel projection
        (rows 0-2 of K_src [R|t]_src^-1 [R|t]_ref K_ref^-1)
    :param depth: (B, D, H, W) float32 depth hypotheses of the reference
    :param min_depth_thres: samples whose source z is below it are zero
    :return: (B, D, H, W, C) of img's dtype
    """
    if torch.is_grad_enabled() and (ref_to_src.requires_grad
                                    or depth.requires_grad):
        raise ValueError("warp_sample: no gradient flows to the matrix or "
                         "the depths; detach them")
    return torch.ops.tandem.warp_sample(img, ref_to_src, depth,
                                        float(min_depth_thres))


def _check_sweep(img, ref_to_src, depth):
    _check("warp_sample", img, (ref_to_src, depth))
    B, H, W, C = img.shape
    if ref_to_src.shape != (B, 3, 4) or depth.dim() != 4 \
            or depth.shape[0] != B or depth.shape[2:] != (H, W):
        raise ValueError(f"warp_sample: want ref_to_src ({B}, 3, 4) and "
                         f"depth ({B}, D, {H}, {W}), got "
                         f"{tuple(ref_to_src.shape)} {tuple(depth.shape)}")


@torch.library.custom_op("tandem::warp_sample", mutates_args=(),
                         device_types="cpu")
def _warp_sample_op(img: torch.Tensor, ref_to_src: torch.Tensor,
                    depth: torch.Tensor,
                    min_depth_thres: float) -> torch.Tensor:
    """The op on the CPU: the plain version."""
    _check_sweep(img, ref_to_src, depth)
    return warp_sample_plain(img, ref_to_src, depth, min_depth_thres)


@_warp_sample_op.register_kernel("cuda")
def _warp_sample_cuda(img, ref_to_src, depth, min_depth_thres):
    """The op on the card: the forward kernel's launch."""
    _check_sweep(img, ref_to_src, depth)
    B, H, W, C = img.shape
    D = depth.shape[1]
    if B * D > MAX_PLANES or _too_large(H, W, C):
        raise ValueError(f"warp_sample: {B} x {D} planes of {H} x {W} x {C} "
                         "exceed the kernel's grid or offsets")
    out = img.new_empty((B, D, H, W, C))
    if out.numel() == 0:
        return out
    vec, rows, planes = _plan(B, D, H, W, C, img.element_size(),
                              img.data_ptr() % 16, img.get_device())
    launch("tandem_warp_sample", img.device, _SWEEP_ARGS.pack(
        img.data_ptr(), ref_to_src.data_ptr(), depth.data_ptr(),
        out.data_ptr(), B, D, H, W, C, vec, rows, planes,
        int(img.dtype == torch.bfloat16), min_depth_thres))
    warp_sample.launches += 1
    return out


@_warp_sample_op.register_fake
def _(img, ref_to_src, depth, min_depth_thres):
    _check_sweep(img, ref_to_src, depth)
    B, H, W, C = img.shape
    return img.new_empty((B, depth.shape[1], H, W, C))


def _warp_sample_setup(ctx, inputs, output):
    _, ref_to_src, depth, min_depth_thres = inputs
    ctx.save_for_backward(ref_to_src, depth)
    ctx.min_depth_thres = min_depth_thres


def _warp_sample_backward(ctx, grad_out):
    """``warp_sample_grad``'s float32 sums in the image's dtype; none for
    the matrix and the depths. The module's name is looked up at each call,
    so a recorder put in its place sees every backward call."""
    ref_to_src, depth = ctx.saved_tensors
    grad = warp_sample_grad(grad_out.contiguous(), ref_to_src, depth,
                            ctx.min_depth_thres)
    return grad.to(grad_out.dtype), None, None, None


torch.library.register_autograd("tandem::warp_sample", _warp_sample_backward,
                                setup_context=_warp_sample_setup)


def warp_sample_grad(grad_out, ref_to_src, depth,
                     min_depth_thres: float = 0.001):
    """The gradient of ``warp_sample`` with respect to its image, as float32
    sums (the backward rounds them to the image's dtype).

    :param grad_out: (B, D, H, W, C) float32 or bfloat16, contiguous: the
        gradient of the warped volume
    :param ref_to_src, depth, min_depth_thres: the forward's
    :return: (B, H, W, C) float32
    """
    return torch.ops.tandem.warp_sample_grad(grad_out, ref_to_src, depth,
                                             float(min_depth_thres))


def _check_grad(grad_out, ref_to_src, depth):
    if grad_out.dim() != 5 or not grad_out.is_contiguous():
        raise ValueError("warp_sample_grad: grad_out must be a contiguous "
                         f"(B, D, H, W, C), got {tuple(grad_out.shape)}")
    B, D, H, W, C = grad_out.shape
    _check("warp_sample_grad", grad_out.view(B, D * H, W, C),
           (ref_to_src, depth))
    if ref_to_src.shape != (B, 3, 4) or depth.shape != (B, D, H, W):
        raise ValueError(f"warp_sample_grad: want ref_to_src ({B}, 3, 4) and "
                         f"depth ({B}, {D}, {H}, {W}); got "
                         f"{tuple(ref_to_src.shape)} {tuple(depth.shape)}")


@torch.library.custom_op("tandem::warp_sample_grad", mutates_args=(),
                         device_types="cpu")
def _warp_sample_grad_op(grad_out: torch.Tensor, ref_to_src: torch.Tensor,
                         depth: torch.Tensor,
                         min_depth_thres: float) -> torch.Tensor:
    """The gradient op on the CPU: the plain version."""
    _check_grad(grad_out, ref_to_src, depth)
    return warp_sample_grad_plain(grad_out, ref_to_src, depth,
                                  min_depth_thres)


@_warp_sample_grad_op.register_kernel("cuda")
def _warp_sample_grad_cuda(grad_out, ref_to_src, depth, min_depth_thres):
    """The gradient op on the card: the gradient kernel's launch with the
    tiling of ``_grad_vec`` and ``grad_tiling``."""
    _check_grad(grad_out, ref_to_src, depth)
    B, D, H, W, C = grad_out.shape
    if B * D > MAX_PLANES or _too_large(H, W, C):
        raise ValueError(f"warp_sample_grad: {B} x {D} planes of {H} x {W} "
                         f"x {C} exceed the kernel's grid or offsets")
    vec = _grad_vec(C, grad_out.element_size(), grad_out.data_ptr())
    planes = grad_tiling(B, D, H, W, C // vec,
                         _sm_count(grad_out.get_device()))
    return _grad_call(grad_out, ref_to_src, depth, min_depth_thres, vec,
                      planes)


@_warp_sample_grad_op.register_fake
def _(grad_out, ref_to_src, depth, min_depth_thres):
    _check_grad(grad_out, ref_to_src, depth)
    B, D, H, W, C = grad_out.shape
    return grad_out.new_empty((B, H, W, C), dtype=torch.float32)


def _grad_call(grad_out, ref_to_src, depth, min_depth_thres: float,
               vec: int, planes: int):
    """The gradient kernel's launch into zeroed float32 sums, with ``vec``
    channels a lane and ``planes`` planes a thread (the inputs checked by
    warp_sample_grad; tests launch other ``planes`` through it)."""
    B, D, H, W, C = grad_out.shape
    acc = torch.zeros((B, H, W, C), dtype=torch.float32,
                      device=grad_out.device)
    if grad_out.numel() == 0:
        return acc
    launch("tandem_warp_sample_grad", grad_out.device, _GRAD_ARGS.pack(
        grad_out.data_ptr(), ref_to_src.data_ptr(), depth.data_ptr(),
        acc.data_ptr(), B, D, H, W, C, vec, planes,
        int(grad_out.dtype == torch.bfloat16), min_depth_thres, 0))
    warp_sample_grad.launches += 1
    return acc


def warp_variance_plain(img, ref_to_src, depth, vol_sum, vol_sq_sum,
                        first: bool, min_depth_thres: float = 0.001):
    """The variance step in torch ops: ``warp_sample_plain``'s volume
    ``warped`` and ``warped ** 2`` written to the sums (``first``) or added
    to them, in place, as the eager cascade accumulates them."""
    warped = warp_sample_plain(img, ref_to_src, depth, min_depth_thres)
    if first:
        vol_sum.copy_(warped)
        vol_sq_sum.copy_(warped ** 2)
    else:
        vol_sum.add_(warped)
        vol_sq_sum.add_(warped ** 2)


def warp_variance(img, ref_to_src, depth, sums=None,
                  min_depth_thres: float = 0.001):
    """One source view's step of the variance cost volume: its plane-sweep
    samples x (``warp_sample``'s) added to the running sums of x and x * x.

    :param img, ref_to_src, depth, min_depth_thres: as ``warp_sample``'s
    :param sums: the running (sum, sum of squares), each (B, D, H, W, C)
        of img's dtype, contiguous, updated in place; None for the first
        view, whose x and x * x are written to new tensors
    :return: the (sum, sum of squares)
    """
    first = sums is None
    if first:
        B, H, W, C = img.shape
        shape = (B, depth.shape[1], H, W, C)
        sums = (img.new_empty(shape), img.new_empty(shape))
    torch.ops.tandem.warp_variance(img, ref_to_src, depth, sums[0], sums[1],
                                   first, float(min_depth_thres))
    return sums


def _check_variance(img, ref_to_src, depth, vol_sum, vol_sq_sum):
    _check_sweep(img, ref_to_src, depth)
    B, H, W, C = img.shape
    shape = (B, depth.shape[1], H, W, C)
    for t in (vol_sum, vol_sq_sum):
        if t.shape != shape or t.dtype != img.dtype \
                or t.device != img.device or not t.is_contiguous():
            raise ValueError(f"warp_variance: want contiguous {img.dtype} "
                             f"sums of shape {shape} on {img.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


@torch.library.custom_op("tandem::warp_variance",
                         mutates_args=("vol_sum", "vol_sq_sum"),
                         device_types="cpu")
def _warp_variance_op(img: torch.Tensor, ref_to_src: torch.Tensor,
                      depth: torch.Tensor, vol_sum: torch.Tensor,
                      vol_sq_sum: torch.Tensor, first: bool,
                      min_depth_thres: float) -> None:
    """The op on the CPU: the plain version."""
    _check_variance(img, ref_to_src, depth, vol_sum, vol_sq_sum)
    warp_variance_plain(img, ref_to_src, depth, vol_sum, vol_sq_sum, first,
                        min_depth_thres)


@_warp_variance_op.register_kernel("cuda")
def _warp_variance_cuda(img, ref_to_src, depth, vol_sum, vol_sq_sum, first,
                        min_depth_thres):
    """The op on the card: one launch of the variance kernel, with the
    forward's tiling (the vector width aligned to the sums too)."""
    _check_variance(img, ref_to_src, depth, vol_sum, vol_sq_sum)
    B, H, W, C = img.shape
    D = depth.shape[1]
    if B * D > MAX_PLANES or _too_large(H, W, C):
        raise ValueError(f"warp_variance: {B} x {D} planes of {H} x {W} x "
                         f"{C} exceed the kernel's grid or offsets")
    if vol_sum.numel() == 0:
        return
    misalign = (img.data_ptr() | vol_sum.data_ptr()
                | vol_sq_sum.data_ptr()) % 16
    vec, rows, planes = _plan(B, D, H, W, C, img.element_size(), misalign,
                              img.get_device())
    launch("tandem_warp_variance", img.device, _VARIANCE_ARGS.pack(
        img.data_ptr(), ref_to_src.data_ptr(), depth.data_ptr(),
        vol_sum.data_ptr(), B, D, H, W, C, vec, rows, planes,
        int(img.dtype == torch.bfloat16), min_depth_thres,
        vol_sq_sum.data_ptr(), int(first), 0))
    warp_variance.launches += 1


@_warp_variance_op.register_fake
def _(img, ref_to_src, depth, vol_sum, vol_sq_sum, first, min_depth_thres):
    _check_variance(img, ref_to_src, depth, vol_sum, vol_sq_sum)


def bilinear_sample(img, px, py, keep=None):
    """Sample ``img`` at given pixel positions.

    :param img: (B, H, W, C) float32 or bfloat16, contiguous
    :param px, py: (B, N) float32 pixel positions, contiguous
    :param keep: optional (B, N) bool, contiguous; False samples are zero
    :return: (B, N, C) of img's dtype
    """
    _check("bilinear_sample", img, (px, py), keep)
    B, H, W, C = img.shape
    if px.dim() != 2 or px.shape[0] != B or py.shape != px.shape \
            or (keep is not None and keep.shape != px.shape):
        raise ValueError(f"bilinear_sample: want px, py (and keep) of one "
                         f"({B}, N) shape, got {tuple(px.shape)} "
                         f"{tuple(py.shape)}")
    if not img.is_cuda:
        return bilinear_sample_plain(img, px, py, keep)
    N = px.shape[1]
    if B > MAX_PLANES or N >= MAX_VALUES - 256 or _too_large(H, W, C):
        raise ValueError(f"bilinear_sample: {B} x {N} samples of {H} x {W} "
                         f"x {C} exceed the kernel's grid or offsets")
    out = img.new_empty((B, N, C))
    if out.numel() == 0:
        return out
    vec = _vec(C, img.element_size(), img.data_ptr())
    launch("tandem_bilinear_sample", img.device, _SAMPLE_ARGS.pack(
        img.data_ptr(), px.data_ptr(), py.data_ptr(),
        0 if keep is None else keep.data_ptr(), out.data_ptr(), B, N, H, W,
        C, vec, int(img.dtype == torch.bfloat16), 0))
    bilinear_sample.launches += 1
    return out


warp_sample.launches = 0
warp_sample_grad.launches = 0
warp_variance.launches = 0
bilinear_sample.launches = 0
