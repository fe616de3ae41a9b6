"""Parent against change on one card: the SLAM CLI's frame rate and read
wait. Each run is a fresh process in one checkout that runs
``tandem_dataset preset=dataset`` on tests/fixtures/replica_traj VO only
and then with the trained unit, and prints, for each, frames, seconds,
FPS, the Timer's ``read_frame`` mean (ms a frame: the loop's wait for its
decoded frame) and the result.txt sha256. The runs alternate parent,
change, change, parent, ``--rounds`` times.

    git archive <parent> | tar -x -C _archive_check/parent
    python -m tandem_tpu_torch.experiments.ab_slam _archive_check/parent

Run from the root of the change's checkout, on a card; the card's name
and power limit are printed first. Each run's output and ``ab_slam.json``
go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

RUN = r"""
import hashlib, json, sys, tempfile
import numpy as np
from pathlib import Path
from tandem_tpu_torch.cli import tandem_dataset
fx = Path("tests/fixtures/replica_traj/scene0")
for tag, extra in (("vo", []), ("full", ["mvsnet_folder=exported/tandem"])):
    out = Path(tempfile.mkdtemp())
    res = tandem_dataset.main(["preset=dataset", f"files={fx / 'images'}",
                               f"calib={fx / 'camera_dso.txt'}",
                               f"result_folder={out}", "dr_timing=1",
                               *extra])
    read = res["timer"].intervals["read_frame"]
    print("AB " + json.dumps({
        "run": tag, "frames": res["frames"], "seconds": res["seconds"],
        "fps": res["frames"] / res["seconds"],
        "read_frame_ms": float(np.mean(read)),
        "sha256": hashlib.sha256((out / "result.txt").read_bytes())
        .hexdigest()}), flush=True)
"""


def run(checkout: Path, name: str, out: Path) -> list:
    log = out / f"{name}.log"
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, "-c", RUN], cwd=checkout,
                            stdout=f, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        raise RuntimeError(f"{name} exited {rc}: see {log}")
    return [json.loads(ln[3:]) for ln in log.read_text().splitlines()
            if ln.startswith("AB ")]


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", type=Path, help="the parent's checkout")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", type=Path, default=Path("_archive_check/ab"))
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[ab_slam] {card}", flush=True)
    order = (("parent", args.parent), ("change", Path.cwd()),
             ("change", Path.cwd()), ("parent", args.parent))
    results = {}
    for r in range(args.rounds):
        for i, (tag, checkout) in enumerate(order):
            name = f"{r * len(order) + i + 1}_{tag}"
            results[name] = run(checkout, name, args.out)
            print(f"[ab_slam] {name}: {json.dumps(results[name])}",
                  flush=True)
    (args.out / "ab_slam.json").write_text(json.dumps(
        {"card": card, "runs": results}, indent=1))
    return results


if __name__ == "__main__":
    main()
