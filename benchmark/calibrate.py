"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program's numbers on many seeds and the control's
(the reference in TF32 in the program's place) on some, in one process a
card. The benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 1 2 3 [--out FILE]

Each seed's row goes to standard error as it comes; the last line of
standard output has every number's largest program reading and smallest
control reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402
from benchmark.run import launch  # noqa: E402


def summary(rows):
    """Per number: the largest program reading and the smallest control
    reading, with the seeds."""
    out = {}
    for k in rows[0]["program"]:
        prog = max(rows, key=lambda r: r["program"][k])
        ctl = [r for r in rows if "control" in r]
        out[k] = {"program_max": prog["program"][k], "seed": prog["seed"]}
        if ctl:
            c = min(ctl, key=lambda r: r["control"][k])
            out[k].update(control_min=c["control"][k], control_seed=c["seed"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    spec = harness.cell(args.workload)
    rows = launch(harness.calibrate_rank, spec,
                  (args.seeds, set(args.control_seeds)))
    res = {"workload": args.workload, "rows": rows, "summary": summary(rows)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
