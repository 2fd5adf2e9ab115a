#!/usr/bin/env python3
"""Readings of the judged numbers for the program and for its control, or
for a planted fault, on several seeds in one process:

    python3 slambench/control.py --workload <name> --seeds 1,2,3 \
        --seconds <s> [--fault <name>]

Each seed is one run of the cell at its own size (as `run.py` makes it).
Without `--fault` the numbers are read twice after the window: from what
the program produced, and with the reference computed in TF32 put in the
program's place (the control). With `--fault` (one of `faults.py`) the
fault is planted under the timed path and the program's numbers are read.
Prints one JSON line a seed. The limits in `reference/limits.json` lie
between the program's largest sound reading and the smallest reading of
what set each of them (`set_from`).
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", default=None)
    a = p.parse_args(argv)
    from slambench import faults as F
    from slambench import harness as H
    bench = H.load_bench()
    cell = H.cell_of(bench, a.workload)
    for seed in (int(s) for s in a.seeds.split(",")):
        patcher = F.Patcher()
        if a.fault:
            F.plant(a.fault, patcher)
        try:
            r = H.run_cell(bench, cell, seed, a.seconds, False, "cuda",
                           time.perf_counter(),
                           log=lambda *m: print(*m, file=sys.stderr),
                           control=not a.fault)
        finally:
            patcher.undo()
        line = {"workload": a.workload, "seed": seed, "fault": a.fault,
                "correct": r["correct"],
                "program": {k: v["value"] for k, v in r["checks"].items()}}
        if "control" in r:
            line["control"] = r["control"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
