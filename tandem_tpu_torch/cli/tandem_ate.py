"""ATE/RPE CLI over TUM-format trajectories (evaluate_ate.py equivalent).

Port of ``tandem_tpu/cli/tandem_ate.py`` on the port's ``eval/ate.py``.

Usage:
  python -m tandem_tpu_torch.cli.tandem_ate --est result.txt --gt gt_tum.txt
      [--scale] [--rpe] [--max-difference 0.02]
"""

from __future__ import annotations

import argparse

parser = argparse.ArgumentParser()
parser.add_argument("--est", required=True)
parser.add_argument("--gt", required=True)
parser.add_argument("--scale", action="store_true",
                    help="Sim(3) alignment (align_se3.py behaviour)")
parser.add_argument("--rpe", action="store_true")
parser.add_argument("--max-difference", type=float, default=0.02)


def main(args):
    from ..eval.ate import (associate, evaluate_ate, load_tum_trajectory,
                            tum_to_xyz)

    est = load_tum_trajectory(args.est)
    gt = load_tum_trajectory(args.gt)
    matches = associate(gt, est, max_difference=args.max_difference)
    if len(matches) < 2:
        raise SystemExit("Couldn't associate trajectories "
                         f"({len(matches)} matches)")
    gt_xyz = tum_to_xyz(gt, [m[0] for m in matches])
    est_xyz = tum_to_xyz(est, [m[1] for m in matches])
    res = evaluate_ate(gt_xyz, est_xyz, with_scale=args.scale)
    print(f"compared_pose_pairs {res['num_pairs']} pairs")
    print(f"absolute_translational_error.rmse {res['rmse']:.6f} m")
    print(f"absolute_translational_error.mean {res['mean']:.6f} m")
    print(f"absolute_translational_error.median {res['median']:.6f} m")
    print(f"absolute_translational_error.std {res['std']:.6f} m")
    print(f"absolute_translational_error.min {res['min']:.6f} m")
    print(f"absolute_translational_error.max {res['max']:.6f} m")
    if args.scale:
        print(f"alignment_scale {res['scale']:.6f}")
    return res


if __name__ == "__main__":
    main(parser.parse_args())
