"""One keyframe's TransMVSNet forward in operations, counted from the
configuration's shapes whatever implements it (multiply-adds x 2, as
``work.mvsnet_ops`` counts CVA-MVSNet's): the V images' FeatureNet, ARF's
convolutions, the FMT's projections, MLPs and attention contractions,
the pathway, stage 1's view-weight net, the correlations and each stage's
U-Net on its 1-channel volume."""

from __future__ import annotations

from . import work

VIEW_WEIGHT_CHANNELS = (16, 8)   # the view-weight net's hidden widths


def _conv(spatial_out: int, cin: int, cout: int, taps: int) -> int:
    return 2 * spatial_out * cin * cout * taps


def fmt_ops(n: int, views: int, d: int, heads: int, blocks: int) -> int:
    """The FMT on ``views`` views of ``n`` tokens of width ``d``: each block
    a self layer on every view and a cross layer on each source view, its
    keys and values from the reference's tokens once."""
    e = d // heads
    query = 2 * n * d * d + 2 * n * heads * e * e + 2 * n * d  # q, KV, Z
    keys = 2 * 2 * n * d * d + 2 * n * heads * e * e         # k, v, KV
    rest = 2 * n * d * d + 2 * n * (2 * d) * (2 * d) + 2 * n * (2 * d) * d
    self_layer = views * (query + keys + rest)
    cross = (views - 1) * (query + rest) + keys
    return blocks * (self_layer + cross)


def mvsnet_ops(config: dict, height: int, width: int, views: int) -> int:
    """One keyframe's forward: ``work.mvsnet_ops``'s contract."""
    b = config["feature_net_base_channels"]
    fmt = dict({"d_model": 4 * b, "heads": 8, "blocks": 4},
               **config.get("fmt", {}))
    c0, c1 = VIEW_WEIGHT_CHANNELS
    shapes = list(work.stage_shapes(config, height, width).values())
    ops = views * work.feature_net_ops(height, width, b)
    for D, H, W, C in shapes:
        # ARF: the offsets' and the modulation's 3x3 convolutions, 9 taps
        ops += views * (_conv(H * W, C, 18 + 9, 9) + _conv(H * W, C, C, 9))
    _, h1, w1, c = shapes[0]
    ops += fmt_ops(h1 * w1, views, fmt["d_model"], fmt["heads"],
                   fmt["blocks"])
    (_, h2, w2, c2), (_, h3, w3, c3) = shapes[1:]
    ops += views * (_conv(h1 * w1, c, c2, 1) + _conv(h2 * w2, c2, c2, 9)
                    + _conv(h2 * w2, c2, c3, 1) + _conv(h3 * w3, c3, c3, 9))
    D1 = shapes[0][0]
    ops += (views - 1) * 2 * D1 * h1 * w1 * (c0 + c0 * c1 + c1)
    for i, (D, H, W, C) in enumerate(shapes):
        ops += (views - 1) * 2 * D * H * W * C
        ops += work.cost_reg_ops(D, H, W, 1,
                                 config["cost_volume_base_channels"][i])
    return ops
