#!/usr/bin/env python3
"""`spans.py` with bundle adjustment's spans read too: one run of a frames
cell with the program's tracer on, printing the result line with
`spans.py`'s seven span metrics and `ba.host_ms` (the mean host ms of a
`ba.run` span, `metrics/ba.host_ms.py`), `spans.py`'s summary line, then a
line with the window's BA runs split by their spans:

    python3 slambench/ba_spans.py --workload ncd_cells.walk --seed <n> \\
        --seconds 50 --trace 1

The split gives each `ba.*` span's host ms a BA run (total, over the
untraced window frames' runs), the runs counted, and the iterations a run
(`ba.iter` spans).
"""

from __future__ import annotations

import json
import sys
from contextlib import contextmanager
from pathlib import Path
from typing import Dict

BA_SPANS = ("ba.run", "ba.collect", "ba.iter", "ba.loss", "ba.backward",
            "ba.capture", "ba.replay", "ba.step", "ba.writeback")


def ba_split(run) -> dict:
    """Host ms a BA run of each `ba.*` span, the runs and the iterations a
    run, over the window's untraced frames; {} without a BA run."""
    from slambench.spans import untraced_frames
    keep = set(untraced_frames(run))
    rec = [r for r in getattr(run, "program", None) or []
           if r.name in BA_SPANS and r.frame in keep]
    runs = sum(r.name == "ba.run" for r in rec)
    if not runs:
        return {}
    ms: Dict[str, float] = {}
    for r in rec:
        ms[r.name] = ms.get(r.name, 0.0) + (r.end_ns - r.start_ns) * 1e-6 \
            / runs
    return {"runs": runs, "ms_per_run": ms,
            "iters_per_run": sum(r.name == "ba.iter" for r in rec) / runs}


@contextmanager
def ba_harness():
    """`spans.traced_harness` with `ba.host_ms` among a traced run's
    metrics. Yields the list the runs are appended to."""
    from slambench import harness as H
    from slambench import spans as SP
    with SP.traced_harness() as runs:
        o_metrics_of = H.metrics_of

        def metrics_of(bench, workload, trace):
            out = o_metrics_of(bench, workload, trace)
            return out + [{"name": "ba.host_ms", "unit": "ms"}] if trace \
                else out

        H.metrics_of = metrics_of
        try:
            yield runs
        finally:
            H.metrics_of = o_metrics_of


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from slambench import run as R          # first: it sets the threads
    from slambench import spans as SP
    with ba_harness() as runs:
        rc = R.main(argv)
    if rc == 0 and runs:
        print(json.dumps(SP.summary(runs[-1])), flush=True)
        print(json.dumps({"ba": ba_split(runs[-1])}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
