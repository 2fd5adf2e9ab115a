#!/usr/bin/env python3
"""Run one cell of the benchmark of `pin_slam_tpu_torch` once:

    python3 slambench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA card(s) the cell
asks for. It builds the cell's inputs from the seed, sets up and warms up
(`setup_s`), measures for `--seconds`, then judges what the timed path
produced against the plain reference (`correct`), and prints one JSON line
last on standard output: the cell's end-to-end metrics (`--trace 0`) or
its per-layer metrics (`--trace 1`). The numbers judged, each beside its
limit, end standard error and the result line.
"""

import os
import time

T_PROCESS = time.perf_counter()
# one process with few threads: the frame loop is host-bound, and idle
# thread pools that spin beside it make its times spread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "4"

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    # every build and kernel cache inside the checkout, at a fixed path
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")

    from slambench import harness as H
    bench = H.load_bench()
    cell = H.cell_of(bench, a.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slambench: the cell needs {cell['chips']} CUDA card(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    result = H.run_cell(bench, cell, a.seed, a.seconds, bool(a.trace),
                        "cuda", T_PROCESS,
                        log=lambda *m: print(*m, file=sys.stderr,
                                             flush=True))
    found = H.forbidden_modules()
    if found:
        print(f"slambench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    H.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
