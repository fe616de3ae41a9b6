"""The cost regulariser's decoder step (``ops/deconv3d.py``) on the CPU.

``deconv_bn_relu_add_plain`` is the card kernel's phase gather and tap
order in torch ops (the kernel itself runs only on the card:
``tests/test_torch_cuda.py`` holds it against the eager step); here it is
held against the eager step it replaces, ``F.conv_transpose3d`` with the
folded BatchNorm, the ReLU and the skip, at both strides, both dtypes,
odd input sizes and D = 1, with and without a skip. The model's CPU path
keeps the eager step: ``DeconvBnRelu`` and ``CostRegNet`` on the CPU, in
eval and in training, give the bits of the composition they ran before
the skip moved into the step.
"""

import copy

import pytest
import torch
import torch.nn.functional as F

from tandem_tpu_torch.models.cost_reg import CostRegNet
from tandem_tpu_torch.models.layers import (DeconvBnRelu, apply_bn,
                                            batch_norm_train, conv_in)
from tandem_tpu_torch.ops import deconv3d as dc
from torch_cases import DECONV_CONFIGS, decoder_steps

DTYPES = [torch.float32, torch.bfloat16]
STRIDES = [(2, 2, 2), (1, 2, 2)]
# (Ci, Co, D, H, W) of the input: odd H and W (CostRegNet's deepest level
# at abl04's stage 1 is 15 x 20, at CasMVSNet's 27 x 36), D = 1 (its
# deepest level at D = 8: 1 -> 2, and at D = 4 with stride (1, 2, 2)).
SHAPES = [(16, 8, 3, 15, 27), (64, 32, 1, 4, 5), (32, 16, 2, 7, 9)]


def _case(dtype, stride, shape, with_skip: bool, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    Ci, Co, D, H, W = shape
    x = torch.relu(torch.randn(2, Ci, D, H, W, generator=g)).to(dtype)
    w = (0.1 * torch.randn(Ci, Co, 3, 3, 3, generator=g)).to(dtype)
    inv = (0.2 + 2 * torch.rand(Co, generator=g)).to(dtype)
    off = (0.3 * torch.randn(Co, generator=g)).to(dtype)
    skip = torch.relu(torch.randn(dc.output_shape(x.shape, Co, stride),
                                  generator=g)).to(dtype) \
        if with_skip else None
    return x, w, inv, off, skip


def _epilogue(c, inv, off, skip):
    shape = (1, -1, 1, 1, 1)
    y = F.relu(c * inv.reshape(shape) + off.reshape(shape))
    return y if skip is None else skip + y


def _neighbours(c):
    """c and its two neighbours in c's dtype."""
    return (torch.nextafter(c, torch.full_like(c, -float("inf"))), c,
            torch.nextafter(c, torch.full_like(c, float("inf"))))


@pytest.mark.parametrize("with_skip", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("stride", STRIDES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_gather_equals_eager_step(dtype, stride, shape, with_skip):
    """The op on the CPU (the plain gather) against the eager step. float32:
    each output within 1e-5 of the scale of its terms (the products'
    absolute sum through |inv|, |off| and the skip: the two sum in other
    orders). bfloat16: each output is the eager epilogue of the eager
    convolution's bfloat16 value or of one of its two neighbours (the sums
    round to bfloat16 once, from float32 sums in other orders), and within
    one bfloat16 ulp of the eager output."""
    x, w, inv, off, skip = _case(dtype, stride, shape, with_skip)
    got = dc.deconv_bn_relu_add(x, w, inv, off, skip, stride)
    assert torch.equal(got, dc.deconv_bn_relu_add_plain(
        x, w, inv, off, skip, stride))
    op = tuple(s - 1 for s in stride)
    c = F.conv_transpose3d(x, w, None, stride, 1, op)
    want = _epilogue(c, inv, off, skip)
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        terms = F.conv_transpose3d(x.abs(), w.abs(), None, stride, 1, op)
        scale = _epilogue(terms, inv.abs(), off.abs(),
                          None if skip is None else skip.abs())
        assert ((got - want).abs() <= 1e-5 * scale).all()
        return
    hit = torch.zeros_like(got, dtype=torch.bool)
    for cand in _neighbours(c):
        hit |= got == _epilogue(cand, inv, off, skip)
    assert hit.all()
    a = want.float().abs()
    ulp = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))
                          ).float() - a
    assert ((got.float() - want.float()).abs() <= ulp).all()


@pytest.mark.parametrize("stride", STRIDES)
def test_plain_gather_is_the_convolution(stride):
    """``deconv_plain``'s phase gather is conv_transpose3d: against the
    float64 convolution within float32 rounding, for one input channel at
    a time in each input position (every tap of every phase)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 3, 2, 5, 7, generator=g)
    w = torch.randn(3, 4, 3, 3, 3, generator=g)
    got = dc.deconv_plain(x, w, list(stride))
    want = F.conv_transpose3d(x.double(), w.double(), None, stride, 1,
                              tuple(s - 1 for s in stride))
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got.double(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("with_skip", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decoder_layer_on_the_cpu_is_unchanged(dtype, with_skip, train):
    """``DeconvBnRelu`` on the CPU, in eval and in training: the skip added
    by the layer gives the bits of the eager composition (the deconvolution,
    the BatchNorm, the ReLU, then ``skip + ``), and training updates the
    running statistics as before."""
    torch.manual_seed(2)
    layer = DeconvBnRelu(16, 8, stride=(1, 2, 2), output_padding=(0, 1, 1),
                         dtype=dtype)
    with torch.no_grad():
        layer.bn.running_mean.uniform_(-0.1, 0.1)
        layer.bn.running_var.uniform_(0.5, 1.5)
    before = copy.deepcopy(layer)
    x = torch.relu(torch.randn(1, 16, 3, 5, 6)).to(dtype)
    skip = torch.randn(1, 8, 3, 10, 12).to(dtype) if with_skip else None
    with torch.set_grad_enabled(train):
        got = layer(x, train, skip=skip)
        c = before.conv
        y = F.conv_transpose3d(x, c.weight.to(dtype), None, c.stride,
                               c.padding, c.output_padding)
        y = F.relu(batch_norm_train(y, before.bn) if train
                   else apply_bn(y, before.bn, dtype))
        want = y if skip is None else skip + y
    assert got.dtype == want.dtype and torch.equal(got, want)
    for a, b in zip(layer.bn.buffers(), before.bn.buffers()):
        assert torch.equal(a, b)


def _cost_reg_before(net, x, train):
    """CostRegNet's forward as it ran before each step took its skip."""
    t = train
    conv0 = net.conv0(x, t)
    conv2 = net.conv2(net.conv1(conv0, t), t)
    conv4 = net.conv4(net.conv3(conv2, t), t)
    x = net.conv6(net.conv5(conv4, t), t)
    x = conv4 + net.conv7(x, t)
    x = conv2 + net.conv9(x, t)
    x = conv0 + net.conv11(x, t)
    return conv_in(net.prob, x, net.dtype)[:, 0]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("four", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cost_reg_net_on_the_cpu_is_unchanged(dtype, four, train):
    """``CostRegNet`` on the CPU (stride 2 and the four-depth (1, 2, 2)
    deepest level, eval and training): the logits and the running
    statistics equal those of the forward before the change, bit for
    bit."""
    torch.manual_seed(3)
    net = CostRegNet(8, 8, has_four_depths=four, dtype=dtype)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm3d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    before = copy.deepcopy(net)
    D = 4 if four else 8
    x = torch.randn(1, 8, D, 16, 24).to(dtype)
    with torch.set_grad_enabled(train):
        got = net(x, train)
        want = _cost_reg_before(before, x, train)
    assert got.dtype == want.dtype and torch.equal(got, want)
    for a, b in zip(net.buffers(), before.buffers()):
        assert torch.equal(a, b)


def test_op_rejects_bad_input():
    x, w, inv, off, skip = _case(torch.float32, (2, 2, 2), SHAPES[2], True)
    bad = {
        "stride": (x, w, inv, off, skip, (2, 1, 2)),
        "dtype": (x.bfloat16(), w, inv, off, skip, (2, 2, 2)),
        "weight": (x, w[:, :, :2], inv, off, skip, (2, 2, 2)),
        "skip": (x, w, inv, off, skip[..., :-1], (2, 2, 2)),
        "bn": (x, w, inv[:-1], off, skip, (2, 2, 2)),
        "layout": (x.transpose(3, 4), w, inv, off, None, (2, 2, 2)),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError, match="deconv_bn_relu_add"):
            dc.deconv_bn_relu_add(*args)


OPCHECK = {
    "f32 stride 2 skip": (torch.float32, (2, 2, 2), True),
    "bf16 stride (1, 2, 2)": (torch.bfloat16, (1, 2, 2), True),
    "f32 no skip": (torch.float32, (2, 2, 2), False),
}


@pytest.mark.parametrize("case", OPCHECK)
def test_deconv_op_opcheck(case):
    """Schema, fake (meta) implementation and dispatch of
    ``tandem::deconv_bn_relu_add`` on the CPU."""
    dtype, stride, with_skip = OPCHECK[case]
    x, w, inv, off, skip = _case(dtype, stride, (4, 2, 2, 3, 5), with_skip)
    torch.library.opcheck(torch.ops.tandem.deconv_bn_relu_add,
                          (x, w, inv, off, skip, list(stride), True))


@pytest.mark.parametrize("config", DECONV_CONFIGS)
def test_main_path_decoder_steps_cover_the_kernels_edges(config):
    """The decoder steps the card tests take from each configuration's
    model (``decoder_steps``, forward hooks on a meta copy): 3 a stage,
    conv7, conv9 and conv11 in call order, each with the layer's stride
    and its skip of the output's shape, and, over the configuration, the
    shapes the kernel treats apart: odd H (the deepest level of stage 1)
    and D = 1, with stride (1, 2, 2) at the four-plane stages."""
    from tandem_tpu_torch.models.cva_mvsnet import CvaMVSNet
    _, dtype, size, depth_num = DECONV_CONFIGS[config]
    with torch.device("meta"):
        model = CvaMVSNet(depth_num=depth_num, dtype=getattr(torch, dtype))
    steps = decoder_steps(model, size)
    assert [s[:2] for s in steps] == [
        (f"stage{i}", n) for i in (1, 2, 3)
        for n in ("conv7", "conv9", "conv11")]
    for stage, name, ci, co, _, stride in steps:
        layer = getattr(model.cost_regularization_net[stage], name)
        assert (ci, co, stride) == (layer.conv.in_channels,
                                    layer.conv.out_channels,
                                    tuple(layer.conv.stride))
    assert any(s[4][1] % 2 for s in steps)
    assert any(s[4][0] == 1 for s in steps)
    assert any(s[5] == (1, 2, 2) for s in steps) == (4 in depth_num)
