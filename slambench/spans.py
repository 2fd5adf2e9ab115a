#!/usr/bin/env python3
"""The program's own spans (`pin_slam_tpu_torch/utils/tracing.py`) read
against a run of a frames cell.

The program opens a span at each stage boundary of its frame loop. With
its tracer on, it keeps every span in memory (name, start, end, parent,
frame id) and, while `torch.profiler` records, opens each as a
`pin_slam.<name>` range of the trace, on the clock of the kernels it
launched. This module reads both:

- `attribute(events)`: from the profiled stretch, the card's idle time
  put down to the innermost program span the host was in at each moment
  of it (`idle_by_span`, "outside" under none: a gap that runs from the
  pull through the loop hook into the next frame is split among them,
  where the harness's `idle_gaps` name a gap by its midpoint alone), the
  kernel-launch runtime calls
  counted to the innermost program span whose host interval holds them,
  whatever thread made them (`launches_by_span`: autograd launches the
  backward's kernels from its own thread while the frame loop waits), and
  the blocking runtime syncs inside `frame` spans (`syncs`: count, host
  seconds; `syncs_by_span`: counts by innermost span).
- `mean_span_ms(run, name)`: a span's host ms a frame over the window's
  frames the profiler did not trace (the profiler slows dispatch-heavy
  stages), from the records on `run.program`. The readers
  `metrics/{loop.host_ms,tracker.host_ms,mapper.dispatch_ms,
  mapper.launches,frame.host_syncs,frame.sync_wait_ms,
  setup.first_frame_s}.py` read these.

The harness does not switch the tracer on yet (section 7 of PERF.md).
Run as a script, this module runs one cell as `run.py` does, with the
program's tracer on from before set-up to the end of the window, and
prints the result line with those seven metrics, `idle_by_span` and
`launches_by_span` added, then one line with the host ms a frame of each
span (its total and its self time) and the coverage of the frame by its
stage spans:

    python3 slambench/spans.py --workload kitti_cells.drive --seed <n> \\
        --seconds 50 --trace 1

With `--trace 0` it is a timed run with the tracer on: against `run.py
--trace 0` on the same seed, the tracer's cost.
"""

from __future__ import annotations

import bisect
import json
import sys
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional

PREFIX = "pin_slam."
# the runtime API's launch calls; a `cuLaunch*` call counts only where no
# `cudaLaunch*` call holds it (the runtime's own launches go through one)
RUNTIME_LAUNCH, DIRECT_LAUNCH = "cudaLaunch", "cuLaunch"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
# the spans of a training run (`PinSLAMSystem.train`)
MAPPER_TRAIN = ("mapper.train", "mapper.setup", "mapper.iter",
                "mapper.loss", "mapper.backward", "mapper.step",
                "mapper.certainty", "mapper.writeback")
NEW_METRICS = (("loop.host_ms", "ms"), ("tracker.host_ms", "ms"),
               ("mapper.dispatch_ms", "ms"), ("mapper.launches", "kernels"),
               ("frame.host_syncs", "syncs"), ("frame.sync_wait_ms", "ms"),
               ("setup.first_frame_s", "s"))


# ---------------------------------------------------- the profiled stretch

class Painter:
    """The innermost of properly nested intervals at a time: `at(t)` is
    the name of the innermost interval [start, end) that holds t, or
    None."""

    def __init__(self, spans):
        self.times: List[float] = []
        self.names: List[Optional[str]] = []
        stack = []      # (end, name) of the open intervals

        def close_until(t):
            while stack and stack[-1][0] <= t:
                end, _ = stack.pop()
                self.times.append(end)
                self.names.append(stack[-1][1] if stack else None)

        for t0, t1, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            close_until(t0)
            stack.append((t1, name))
            self.times.append(t0)
            self.names.append(name)
        close_until(float("inf"))

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.times, t) - 1
        return self.names[i] if i >= 0 else None

    def split(self, a: float, b: float):
        """[(name, length)] of the stretches of [a, b) under each
        innermost interval (None: under none)."""
        out = []
        i = bisect.bisect_right(self.times, a) - 1
        name = self.names[i] if i >= 0 else None
        t = a
        for j in range(i + 1, len(self.times)):
            if self.times[j] >= b:
                break
            out.append((name, self.times[j] - t))
            t, name = self.times[j], self.names[j]
        out.append((name, b - t))
        return out


def attribute(events) -> dict:
    """`idle_by_span`, `launches_by_span` (dicts by span name, seconds and
    counts), `syncs` ({"count", "seconds"}), `syncs_by_span` and
    `device_busy_s` over the benchmark's `slambench.window` range of a
    profile's events; empty where the trace holds no window or no program
    span. Device work is every device event that is no range: kernels whose
    names hold a '#' (`{lambda(int)#1}`) count, which the harness's
    `summarize_trace` leaves out (PERF.md section 7)."""
    from torch.autograd import DeviceType

    from slambench.harness import _union
    spans, frames, ops, launches, direct, syncs = [], [], [], [], [], []
    window = None
    for e in events:
        t0, t1, name = e.time_range.start, e.time_range.end, e.name
        if e.device_type == DeviceType.CUDA:
            if not (name.startswith(("slambench.", PREFIX))
                    or getattr(e, "is_user_annotation", False)):
                ops.append((t0, t1))
        elif name == "slambench.window":
            window = (t0, t1)
        elif name.startswith(PREFIX):
            spans.append((t0, t1, name[len(PREFIX):]))
            if name == PREFIX + "frame":
                frames.append((t0, t1, "frame"))
        elif name.startswith(RUNTIME_LAUNCH):
            launches.append((t0, t1, e.thread))
        elif name.startswith(DIRECT_LAUNCH):
            direct.append((t0, t1, e.thread))
        elif name in SYNC_CALLS:
            syncs.append((t0, t1))
    if window is None or not spans:
        return {}
    w0, w1 = window
    inner, in_frame = Painter(spans), Painter(frames)
    busy = _union([(max(a, w0), min(b, w1)) for a, b in ops
                   if b > w0 and a < w1])
    idle: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            for name, d in inner.split(a, b):
                if d > 0:
                    name = name or "outside"
                    idle[name] = idle.get(name, 0.0) + d * 1e-6
    runtime = {}
    for t0, t1, thread in launches:
        runtime.setdefault(thread, []).append((t0, t1, "runtime"))
    held_by = {th: Painter(iv) for th, iv in runtime.items()}
    launches += [d for d in direct if d[2] not in held_by
                 or held_by[d[2]].at(d[0]) is None]
    counts: Dict[str, int] = {}
    for t0, _, _ in launches:
        if w0 <= t0 < w1:
            name = inner.at(t0) or "outside"
            counts[name] = counts.get(name, 0) + 1
    held = [(a, b) for a, b in syncs
            if w0 <= a < w1 and in_frame.at(a) is not None]
    sync_counts: Dict[str, int] = {}
    for a, _ in held:
        sync_counts[inner.at(a)] = sync_counts.get(inner.at(a), 0) + 1
    return {"idle_by_span": idle, "launches_by_span": counts,
            "syncs": {"count": len(held),
                      "seconds": sum(b - a for a, b in held) * 1e-6},
            "syncs_by_span": sync_counts,
            "device_busy_s": sum(b - a for a, b in busy) * 1e-6}


# ------------------------------------------------------- the host records

def untraced_frames(run) -> List[int]:
    """The window's frames outside the profiled stretch."""
    from slambench.harness import TRACE_FRAMES, TRACE_SKIP
    fids = [f["fid"] for f in run.frames]
    if not fids:
        return []
    t0 = fids[0] + TRACE_SKIP
    return [f for f in fids if not t0 <= f < t0 + TRACE_FRAMES]


def mean_span_ms(run, name: str) -> Optional[float]:
    """Host ms a frame in spans named `name`, over the window's frames
    that the profiler did not trace; None without records."""
    records = getattr(run, "program", None)
    fids = untraced_frames(run) if records else []
    if not fids:
        return None
    keep = set(fids)
    ns = sum(r.end_ns - r.start_ns for r in records
             if r.name == name and r.frame in keep)
    return ns * 1e-6 / len(fids)


def host_split(run) -> dict:
    """Per span name, host ms a frame (total and self: less the spans
    opened inside it) over the window's untraced frames, and the `frame`
    span's self share of its duration. A span opened between frames (the
    dataset layer's) counts to the frame it precedes."""
    records = getattr(run, "program", None) or []
    keep = set(untraced_frames(run))
    roots = sorted((r.start_ns, r.frame) for r in records
                   if r.name == "frame")
    starts = [t for t, _ in roots]

    def frame_of(r):
        if r.frame is not None:
            return r.frame
        i = bisect.bisect_left(starts, r.end_ns)
        return roots[i][1] if i < len(roots) else None

    rec = [r for r in records if frame_of(r) in keep]
    if not rec:
        return {}
    child_ns: Dict[int, int] = {}
    for r in rec:
        child_ns[r.parent] = child_ns.get(r.parent, 0) + r.end_ns - r.start_ns
    total: Dict[str, float] = {}
    own: Dict[str, float] = {}
    for r in rec:
        d = r.end_ns - r.start_ns
        total[r.name] = total.get(r.name, 0.0) + d * 1e-6 / len(keep)
        own[r.name] = own.get(r.name, 0.0) + (d - child_ns.get(r.id, 0)) \
            * 1e-6 / len(keep)
    return {"frames": len(keep),
            "ms": {n: [total[n], own[n]] for n in sorted(
                total, key=lambda n: -total[n])},
            "frame_self_share": own["frame"] / total["frame"]}


def idle_coverage(trace: dict) -> Optional[float]:
    """Share of the profiled stretch's idle time under a program span
    below `frame` or under a `dataset.*` span."""
    idle = (trace or {}).get("idle_by_span")
    if not idle:
        return None
    total = sum(idle.values())
    return (total - idle.get("outside", 0.0) - idle.get("frame", 0.0)) \
        / total if total else None


# ----------------------------------------------------------- the command

@contextmanager
def traced_harness():
    """The harness with the program's tracer on in each frames run (from
    before set-up to the end of the window; the records go to
    `run.program`), the span fields in the trace summary and the
    breakdown, and the seven span metrics among a traced run's metrics.
    Yields the list the runs are appended to."""
    from slambench import harness as H
    from pin_slam_tpu_torch.utils import tracing

    runs = []
    o_run_frames, o_summarize = H.run_frames, H.summarize_trace
    o_metrics_of, o_breakdown = H.metrics_of, H.breakdown

    def run_frames(*a, **k):
        tracing.drain()
        tracing.enable()
        try:
            run, judge_in = o_run_frames(*a, **k)
        finally:
            tracing.disable()
        run.program = tracing.drain()
        runs.append(run)
        return run, judge_in

    def summarize_trace(prof, n_steps):
        out = o_summarize(prof, n_steps)
        out.update(attribute(prof.events()))
        return out

    def metrics_of(bench, workload, trace):
        out = o_metrics_of(bench, workload, trace)
        if trace:
            out = out + [{"name": n, "unit": u} for n, u in NEW_METRICS]
        return out

    def breakdown(run):
        out = o_breakdown(run)
        if out is not None:
            for key in ("idle_by_span", "launches_by_span"):
                top = sorted(run.trace.get(key, {}).items(),
                             key=lambda kv: -kv[1])[:10]
                out[key] = [[n, v] for n, v in top]
        return out

    H.run_frames, H.summarize_trace = run_frames, summarize_trace
    H.metrics_of, H.breakdown = metrics_of, breakdown
    try:
        yield runs
    finally:
        H.run_frames, H.summarize_trace = o_run_frames, o_summarize
        H.metrics_of, H.breakdown = o_metrics_of, o_breakdown


def summary(run) -> dict:
    """The host split, the idle coverage, the syncs (all, and by span),
    the device's busy seconds and the span count of a run made under
    `traced_harness`."""
    tr = run.trace or {}
    return {"host_split": host_split(run),
            "idle_coverage": idle_coverage(tr),
            "syncs": tr.get("syncs"), "syncs_by_span": tr.get("syncs_by_span"),
            "device_busy_s": tr.get("device_busy_s"),
            "spans": len(run.program)}


def main(argv=None) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from slambench import run as R          # first: it sets the threads
    with traced_harness() as runs:
        rc = R.main(argv)
    if rc == 0 and runs:
        print(json.dumps(summary(runs[-1])), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
