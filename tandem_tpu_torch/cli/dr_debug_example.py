"""Standalone TSDF integration debug harness, on the card.

Port of ``tandem_tpu/cli/dr_debug_example.py`` (the reference's
tandem/libdr/dr_debug_example, dr_debug_example.cpp:43-83): fuses an RGB-D
sequence's sensor depths into the TSDF volume, outside the SLAM pipeline,
and per frame allocates, integrates and raycasts the volume at the frame's
pose; writes each render as a 16-bit PNG (depth / max_depth x 65535) and
the final mesh. Prints the JAX CLI's lines.

Usage:
  python -m tandem_tpu_torch.cli.dr_debug_example --rgb DIR --depth DIR \\
      --calib camera.txt --out OUT [--poses gt_tum.txt] [--limit N] \\
      [--depth-scale S] [--device cpu]

It runs on the card; ``--device cpu`` (this port's own flag) runs it on
the CPU.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

parser = argparse.ArgumentParser()
parser.add_argument("--rgb", required=True)
parser.add_argument("--depth", required=True)
parser.add_argument("--calib", required=True)
parser.add_argument("--poses", default=None,
                    help="TUM-format trajectory; identity if absent")
parser.add_argument("--out", required=True)
parser.add_argument("--depth-scale", type=float, default=1.0 / 5000.0)
parser.add_argument("--limit", type=int, default=20)
parser.add_argument("--device", default=None,
                    help="the card unless given (e.g. cpu)")


def _quat_to_R(qx, qy, qz, qw):
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)],
    ], np.float32)


def read_poses(path: str) -> dict:
    """A TUM trajectory as {frame index: (4, 4) float32 c2w}, in the order
    of its timestamps."""
    from ..eval.ate import load_tum_trajectory
    traj = load_tum_trajectory(path)
    poses = {}
    for i, k in enumerate(sorted(traj)):
        tx, ty, tz, qx, qy, qz, qw = traj[k]
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _quat_to_R(qx, qy, qz, qw)
        T[:3, 3] = (tx, ty, tz)
        poses[i] = T
    return poses


def main(args) -> dict:
    """:return: dict with the TsdfConfig, the volume, the renders (host
    depth maps) and per frame the allocate, integrate and raycast
    seconds (host clock, the device synchronized after each)."""
    import torch

    from ..data.reader import RGBDReader
    from ..data.replica import write_png
    from ..mapping.mesh import extract_mesh, save_obj
    from ..mapping.tsdf import (TsdfConfig, allocate_blocks, create_volume,
                                integrate, raycast)
    from ..pipeline.full_system import resolve_device
    from ..utils.consts import upload
    from .tandem_dataset import read_calib

    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    fx, fy, cx, cy, W, H = read_calib(args.calib)
    K = upload(np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32),
               dev)
    reader = RGBDReader(args.rgb, depth_path=args.depth,
                        depth_scale=args.depth_scale)
    poses = read_poses(args.poses) if args.poses else {}

    cfg = TsdfConfig()
    vol = create_volume(cfg, dev)
    os.makedirs(args.out, exist_ok=True)
    renders, times = [], []
    n = min(len(reader), args.limit)
    for i in range(n):
        depth_np = reader.get_depth(i)
        depth = upload(depth_np, dev)
        bgr = reader.get_image_bgr(i)
        rgb = upload(bgr[..., ::-1], dev)
        pose = upload(poses.get(i, np.eye(4, dtype=np.float32)), dev)
        sync()
        t0 = time.perf_counter()
        allocate_blocks(cfg, vol, depth, K, pose)
        sync()
        t1 = time.perf_counter()
        integrate(cfg, vol, depth, rgb, K, pose)
        sync()
        t2 = time.perf_counter()
        rdepth, _ = raycast(cfg, vol, (K, pose), depth.shape[0],
                            depth.shape[1])
        sync()
        t3 = time.perf_counter()
        d = rdepth.cpu().numpy()
        write_png(os.path.join(args.out, f"render_{i:04d}.png"),
                  (np.clip(d / cfg.max_depth, 0, 1) * 65535
                   ).astype(np.uint16))
        print(f"frame {i}: allocated={int(vol.n_allocated)} "
              f"rendered_valid={float((d > 0).mean()):.2f}", flush=True)
        renders.append(d)
        times.append({"allocate": t1 - t0, "integrate": t2 - t1,
                      "raycast": t3 - t2})

    verts, faces, cols = extract_mesh(cfg, vol)
    save_obj(os.path.join(args.out, "mesh.obj"), verts, faces, cols)
    print(f"mesh: {len(verts)} vertices", flush=True)
    return {"cfg": cfg, "volume": vol, "renders": renders, "times": times,
            "vertices": len(verts), "depth_scale": args.depth_scale}


if __name__ == "__main__":
    main(parser.parse_args())
