"""Readings that set the limits of ``correct``: a cell's compared numbers over
many seeds in one process, for the program as it stands, for the control
(the next precision down in the program's place) or with a fault planted.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1 2 3 --seconds 2 \\
        [--control int8|tf32] [--fault stale|altered|half|nosuppress|unchanged|double]

One JSON line a seed: the numbers compared and whether the run was correct
under the cell's current limits. The benchmark's own runs never call this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from perfbench import run
from perfbench.lib import harness


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", default=None)
    p.add_argument("--fault", action="append", default=[])
    args = p.parse_args(argv)
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = harness.make_cell(args.workload, seed, args.seconds, False,
                                 faults=tuple(args.fault), control=args.control)
        readings = {}
        result = run.execute(cell, t0=t0, readings=readings)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "faults": args.fault, "correct": result["correct"],
                          "checks": {k: v["value"] for k, v in result["checks"].items()},
                          "readings": readings,
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "wall_s": time.perf_counter() - t0}),
              flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded: {found}", file=sys.stderr)
        sys.exit(3)


if __name__ == "__main__":
    main()
