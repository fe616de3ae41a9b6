"""Probe: how much does the monocular trajectory on
tests/fixtures/replica_traj move under changes of the focal length far
below any calibration's accuracy?

Runs a tandem_dataset CLI (preset=dataset, VO only unless ``--mvsnet``)
once per fx in ``--fx`` (fy, cx, cy and the images fixed) and prints each
run's Sim3 ATE against the GT poses, the frames it tracked and its
keyframes. A loop that amplifies rounding spreads its ATE over many
millimetres for fx changes of 5e-7 (the JAX package, whose tracked
rotations drift off SO(3)); the port keeps its tracked poses rigid.
``sweep`` takes the CLI's ``main`` as an argument, so the same sweep runs
either package's CLI. Run from the root of a checkout:

    python -m tandem_tpu_torch.experiments.ate_sensitivity [--device cpu]
"""

from __future__ import annotations

import argparse
import functools
import tempfile
from pathlib import Path

FIXTURE = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / \
    "replica_traj" / "scene0"
UNIT = Path(__file__).resolve().parents[2] / "exported" / "tandem"
FXS = (200.0, 200.0001, 199.9999, 200.001)


def sweep(main, work: Path, fxs=FXS, mvsnet: bool = False) -> list:
    """``main(argv)`` once per fx on the fixture, results under ``work``:
    a row per run with its ATE (mm), frames associated and keyframes."""
    from ..eval.ate import (associate, evaluate_ate, load_tum_trajectory,
                            tum_to_xyz)
    gt = load_tum_trajectory(str(FIXTURE / "gt_tum.txt"))
    rows = []
    for fx in fxs:
        calib = work / f"camera_{fx}.txt"
        calib.write_text(f"Pinhole {fx} 200.0 127.5 95.5 0\n256 192\nnone\n"
                         "256 192\n")
        out = work / f"out_{fx}"
        argv = ["preset=dataset", f"files={FIXTURE / 'images'}",
                f"calib={calib}", f"result_folder={out}"]
        if mvsnet:
            argv.append(f"mvsnet_folder={UNIT}")
        main(argv)
        est = load_tum_trajectory(str(out / "result.txt"))
        m = associate(gt, est)
        ate = evaluate_ate(tum_to_xyz(gt, [a for a, _ in m]),
                           tum_to_xyz(est, [b for _, b in m]),
                           with_scale=True)
        kfs = len((out / "keyframes_dso.txt").read_text().splitlines())
        rows.append({"fx": fx, "ate_mm": ate["rmse"] * 1e3, "frames": len(m),
                     "keyframes": kfs})
    return rows


def main(argv=None):
    from ..cli import tandem_dataset
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--fx", type=float, nargs="+", default=list(FXS))
    ap.add_argument("--mvsnet", action="store_true")
    args = ap.parse_args(argv)
    label = ""
    if args.device in (None, "cuda"):
        from ..utils.cuda_timing import card_label
        label = card_label()
    with tempfile.TemporaryDirectory() as tmp:
        rows = sweep(functools.partial(tandem_dataset.main,
                                       device=args.device),
                     Path(tmp), args.fx, args.mvsnet)
    for row in rows:
        print(f"[ate_sensitivity] {label} {row}", flush=True)
    return rows


if __name__ == "__main__":
    main()
