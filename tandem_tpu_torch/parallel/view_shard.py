"""View-sharded CVA-MVSNet inference over a list of devices.

Port of ``tandem_tpu/parallel/view_shard.py``. The cascade's keyframe cost
is mostly per source view (features, the plane-sweep warp, the gated cost
accumulation), and the views are independent up to one sum of the partial
cost volumes a stage. JAX runs that as one ``shard_map`` program over a
mesh axis; in the port one process drives a list of devices, as
``MvsnetRunner`` lives inside the SLAM process:

- the views are padded to a multiple of the shard count with copies of
  the reference view and carry the JAX masks ``is_ref`` and ``is_src``;
- each shard runs the FeatureNet on its own views only;
- the reference view's features (one sum a stage) and pose are a masked
  sum over the shards, the count of real views a summed scalar, and each
  stage sums the shards' partial volumes in the model's dtype: the eight
  sums (eleven without view aggregation) of the JAX program, at its
  places and with its shapes, all through ``collectives.device_sum``;
- a warp whose mask is 0 (the reference view, a padded view) is skipped:
  its term is exactly 0, so ``warp_sample`` launches once a source view
  and stage at every shard count, as on the monolithic path;
- the CostRegNet and the head run once, on the first device (JAX runs
  them on every chip because it is SPMD), and each stage's depth goes
  back to the shards for the next stage's hypotheses.

A device may repeat in the list (``[cuda:0] * 4`` on one card, ``[cpu] *
n`` in the tests): its shards then run in turn. Inference only: the
BatchNorms use their running statistics. Data parallelism for training is
``train/trainer.py``'s.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch

from ..models.cva_mvsnet import STAGES, CvaMVSNet
from ..models.layers import interpolate_bilinear
from ..models.ranges import adaptive_depth_range, uniform_depth_range
from ..ops.warp import plane_sweep_warp, ref_pixel_to_world
from .collectives import device_sum


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it means now (``cuda:0``): devices compare
    by index."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def build_view_sharded_forward(model: CvaMVSNet, devices: Sequence):
    """The view-sharded forward of ``model`` over ``devices`` (one shard
    each; the model is copied to each distinct device).

    :return: ``fn(image, Ks, cam_to_world, depth_min, depth_max) -> (depth,
        confidence)``: image (B, V, C, H, W) RGB in [0, 1], Ks a 3-tuple
        of (B, 3, 3), cam_to_world (B, V, 4, 4) reference first (the
        ``CvaMVSNet.forward`` contract), depth_min / depth_max (B,); the
        stage-3 depth and confidence (B, H, W), float32, on the first
        device.
    """
    devices = [_indexed(torch.device(d)) for d in devices]
    n = len(devices)
    replicas = {}
    for d in devices:
        if d not in replicas:
            replicas[d] = (model if next(model.parameters()).device == d
                           else copy.deepcopy(model).to(d)).eval()
    models = [replicas[d] for d in devices]
    first = devices[0]

    @torch.no_grad()
    def fn(image, Ks, cam_to_world, depth_min, depth_max):
        B, V, C, H, W = image.shape
        Vl = -(-V // n)
        pad = Vl * n - V
        if pad:
            # Copies of the reference view: real data, so the skipped
            # warps would stay finite; masked out of every sum.
            image = torch.cat([image, image[:, :1].expand(
                B, pad, C, H, W)], 1)
            cam_to_world = torch.cat([cam_to_world, cam_to_world[:, :1]
                                      .expand(B, pad, 4, 4)], 1)
        view = torch.arange(Vl * n)
        is_ref = (view == 0).float()
        is_src = ((view >= 1) & (view < V)).float()

        shards = []
        for k, (dev, m) in enumerate(zip(devices, models)):
            sl = slice(k * Vl, (k + 1) * Vl)
            img = image[:, sl].to(dev).reshape(B * Vl, C, H, W).float()
            feats = m.feature_net(img, False)
            shards.append({
                "feats": {s: f.permute(0, 2, 3, 1).contiguous().reshape(
                    B, Vl, *f.shape[2:], f.shape[1])
                    for s, f in feats.items()},
                "c2w": cam_to_world[:, sl].to(dev),
                "is_ref": is_ref[sl].to(dev),
                "is_src": is_src[sl]})

        def masked(x, sel):
            # Elementwise, like the JAX program's mask-sums: x * 1 and
            # x * 0 are exact, so the sum is the reference view's bits.
            return torch.sum(x * sel.to(x.dtype).reshape(
                1, -1, *(1,) * (x.dim() - 2)), 1)

        def everywhere(x):
            return [x if x.device == d else x.to(d) for d in devices]

        ref_feats = {s: everywhere(device_sum(
            [masked(sh["feats"][s], sh["is_ref"]) for sh in shards]))
            for s in STAGES}
        ref_c2w = everywhere(device_sum(
            [masked(sh["c2w"], sh["is_ref"]) for sh in shards]))
        # The host's masks: the count is a CPU scalar, so the volume's
        # division runs as on the monolithic path.
        v_real = device_sum([sh["is_src"].sum() for sh in shards]) + 1.0

        head = models[0]
        depth = base_interval = None
        for i, stage in enumerate(STAGES):
            hs, ws = H // head.scale[stage], W // head.scale[stage]
            if i == 0:
                ds, base_interval = uniform_depth_range(
                    depth_min=depth_min.to(first),
                    depth_max=depth_max.to(first),
                    depth_num=head.depth_num[0], height=hs, width=ws)
            else:
                up = interpolate_bilinear(depth[..., None].float(), hs,
                                          ws)[..., 0]
                ds = adaptive_depth_range(
                    depth=up,
                    interval=head.depth_interval_ratio[i] * base_interval,
                    depth_num=head.depth_num[i])
            ds_at = everywhere(ds)
            K_at = everywhere(Ks[i].to(first))
            partial = []
            for k, (sh, m) in enumerate(zip(shards, models)):
                gate = m.volume_gates[stage] if m.view_aggregation else None
                feats = sh["feats"][stage]
                ref_volume = ref_feats[stage][k][:, None].to(m.dtype)
                ref_p2w = ref_pixel_to_world(K_at[k], ref_c2w[k])
                acc = None
                for j in range(Vl):
                    if not sh["is_src"][j]:
                        continue
                    warped, _ = plane_sweep_warp(
                        feats[:, j], ds_at[k], src_K=K_at[k],
                        src_cam_to_world=sh["c2w"][:, j], ref_K=K_at[k],
                        ref_cam_to_world=ref_c2w[k], with_mask=False,
                        ref_p2w=ref_p2w)
                    terms = m._view_contrib(warped, ref_volume, gate)
                    acc = list(terms) if acc is None else [
                        a + t for a, t in zip(acc, terms)]
                if acc is None:          # a shard without a source view
                    shape = (B, ds.shape[1], hs, ws, feats.shape[-1])
                    acc = [torch.zeros(shape, dtype=m.dtype,
                                       device=feats.device)
                           for _ in range(1 if gate is not None else 2)]
                partial.append(acc)
            acc = [device_sum(list(terms)) for terms in zip(*partial)]
            volume = head._finalize_volume(
                acc, ref_feats[stage][0][:, None].to(head.dtype), v_real,
                gated=head.view_aggregation)
            depth, conf = head._depth_head(
                volume, ds, head.cost_regularization_net[stage])
        return depth, conf

    return fn
