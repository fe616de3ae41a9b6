"""Initial weights of a CVA-MVSNet from the seed, made on the device in two
large draws: flax's initializers, as training starts (a truncated normal
of variance 1 / fan-in for the convolutions, a uniform of variance
1 / (3 fan-in) for the transposed ones, zero biases, BatchNorm at scale 1,
bias 0, mean 0 and variance 1). The result is in the unit pickle's layout
(flax paths), which the plain reference reads and the program loads."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference.cva_mvsnet import param_shapes

# the standard deviation of the unit normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978
TRANSPOSED = ("/conv7/kernel", "/conv9/kernel", "/conv11/kernel")


def init_params(config: dict, seed: int, device) -> dict:
    """{flax path: float32 tensor on ``device``}."""
    shapes = param_shapes(config)
    kernels = [k for k in shapes if k.endswith("/kernel")]
    transposed = [k for k in kernels if k.endswith(TRANSPOSED)]
    plain = [k for k in kernels if k not in transposed]
    gen = torch.Generator(device=device).manual_seed(seed)
    size = lambda ks: sum(math.prod(shapes[k]) for k in ks)
    normal = torch.empty(size(plain), device=device)
    torch.nn.init.trunc_normal_(normal, 0.0, 1.0, -2.0, 2.0, generator=gen)
    uniform = torch.rand(size(transposed), generator=gen,
                         device=device) * 2 - 1
    out = {}
    for keys, draw, scale in ((plain, normal, 1.0 / TRUNC_STD),
                              (transposed, uniform, 1.0)):
        pos = 0
        for k in keys:
            shape = shapes[k]
            n = math.prod(shape)
            fan_in = math.prod(shape[:-1])
            out[k] = draw[pos:pos + n].view(shape) * (
                math.sqrt(1.0 / fan_in) * scale)
            pos += n
    for k, shape in shapes.items():
        if k not in out:
            ones = k.endswith(("/scale", "/var"))
            out[k] = (torch.ones if ones else torch.zeros)(shape,
                                                          device=device)
    return out


def nested_numpy(params: dict) -> dict:
    """The flat flax paths as the nested dict of numpy arrays a unit's
    pickle holds."""
    tree: dict = {}
    for path, v in params.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy().astype(np.float32)
    return tree
