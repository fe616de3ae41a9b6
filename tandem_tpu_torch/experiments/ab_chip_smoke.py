"""Parent against change on one card: ``chip_smoke.py --profile-dir`` of
two checkouts in the order parent, change, change, parent, and for each run
the map path's per-keyframe times (the slice phases' host-clock medians) and
the device events (kernels, copies, memsets) of its profiled keyframes,
counted in the traces the run writes.

    git archive <parent> | tar -x -C _archive_check/parent
    python -m tandem_tpu_torch.experiments.ab_chip_smoke _archive_check/parent

Run from the root of the change's checkout, on a card. Each run's output
and ``ab.json`` go to ``--out``, the traces (8 MB each) to ``--traces``;
both default to directories under the gitignored ``_archive_check/``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = re.compile(r"^\[slice (float32|bfloat16)\] per keyframe .*?MVSNet "
                   r"([0-9.]+) ms .*?fusion \(allocate\+integrate\+render\) "
                   r"([0-9.]+) ms, total ([0-9.]+) ms", re.M)


def device_events(trace: Path) -> int:
    """Kernels, copies and memsets in a torch.profiler chrome trace."""
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") in DEVICE_CATEGORIES)


def run(checkout: Path, tag: str, out: Path, traces: Path) -> dict:
    prof = (traces / tag).resolve()
    log = out / f"{tag}.log"
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, "chip_smoke.py", "--profile-dir",
                             str(prof)], cwd=checkout, stdout=f,
                            stderr=subprocess.STDOUT).returncode
    text = log.read_text()
    res = {"rc": rc, "last_line": text.strip().splitlines()[-1][:200]}
    for dtype, mvs, fuse, total in SLICE.findall(text):
        res[dtype] = {"mvsnet_ms": float(mvs), "fusion_ms": float(fuse),
                      "total_ms": float(total),
                      "device_events": device_events(
                          prof / f"keyframe_trace_{dtype}.json")}
    return res


def main() -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("parent", type=Path, help="the parent's checkout")
    ap.add_argument("--out", type=Path, default=Path("_archive_check/ab"))
    ap.add_argument("--traces", type=Path,
                    default=Path("_archive_check/ab_traces"))
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    change = Path.cwd()
    results = {}
    for i, (tag, checkout) in enumerate((("parent", args.parent),
                                         ("change", change),
                                         ("change", change),
                                         ("parent", args.parent))):
        name = f"{i + 1}_{tag}"
        results[name] = run(checkout, name, args.out, args.traces)
        print(f"[ab] {name}: {json.dumps(results[name])}", flush=True)
    (args.out / "ab.json").write_text(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
