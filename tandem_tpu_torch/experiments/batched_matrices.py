"""Probe: are the plane sweep's ref->src matrices of all V-1 source views,
computed in one batched pass, equal (torch.equal) on the card to the
per-view ones the cascade uses? Checked on the golden pack's cameras and on
seeded random cameras (rotations up to 0.3 rad, translations up to 1 m), at
the three abl04 stage intrinsics; prints the largest difference. Needs a
card; run from the root of a checkout:

    python -m tandem_tpu_torch.experiments.batched_matrices
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..ops.warp import ref_to_src_matrix
from ..utils.cuda_timing import card_label, require_cuda

PACK = Path("exported/tandem/sample_inputs.npz")


def _random_cameras(rng, views: int) -> np.ndarray:
    out = np.tile(np.eye(4, dtype=np.float32), (1, views, 1, 1))
    for v in range(views):
        a, b = rng.uniform(-0.3, 0.3, 2)
        ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]])
        rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                       [0, np.sin(b), np.cos(b)]])
        out[0, v, :3, :3] = ry @ rx
        out[0, v, :3, 3] = rng.uniform(-1, 1, 3)
    return out


def main() -> dict:
    """Return {(cameras, stage intrinsics): (equal, max |difference|)}."""
    dev = require_cuda()
    print(f"[batched_matrices] {card_label()}", flush=True)
    pack = np.load(PACK)
    cams = {"golden": pack["cam_to_world"],
            "random": _random_cameras(np.random.RandomState(0),
                                      pack["cam_to_world"].shape[1])}
    res = {}
    for name, c in cams.items():
        c2w = torch.from_numpy(c).to(dev)
        V = c2w.shape[1]
        for k in ("K1", "K2", "K3"):
            K = torch.from_numpy(pack[k]).to(dev)
            batched = ref_to_src_matrix(K[:, None], c2w[:, 1:], K[:, None],
                                        c2w[:, :1])
            per_view = torch.stack([ref_to_src_matrix(K, c2w[:, v], K,
                                                      c2w[:, 0])
                                    for v in range(1, V)], 1)
            res[(name, k)] = (torch.equal(batched, per_view),
                              float((batched - per_view).abs().max()))
            print(f"[batched_matrices] {name} cameras, {k}: equal "
                  f"{res[(name, k)][0]}, max |difference| "
                  f"{res[(name, k)][1]:.3e}", flush=True)
    return res


if __name__ == "__main__":
    main()
