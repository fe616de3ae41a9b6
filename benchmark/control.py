"""The correctness check's controls: a run of a cell with some of its
configuration's ``controls`` in the program's place, each a layer in the
precision below the configuration's:

- ``mvsnet``: the plain CVA-MVSNet in fp8 serving the map path's calls;
- ``tracker``: the tracker's LM with its planes, point depths and
  intensities, and its state rounded to bfloat16 at each level;
- ``tsdf``: the plain TSDF integrator keeping its volume in bfloat16,
  fed the scans the program fused, as the volume compared;
- ``train``: the plain training step in TF32, taking the steps compared.

    python3 benchmark/control.py --control NAME[,NAME] --workload NAME \\
        --seed N --seconds S

prints the same result line as ``run.py``, whose ``correct`` has to come
out false and whose ``checks`` are the control's readings. The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--control", required=True)
    args, rest = ap.parse_known_args()
    sys.exit(run.main(rest, control=tuple(args.control.split(","))))
