"""Mean host ms of a bundle-adjustment run (the program's `ba.run` span),
over the window's BA runs in frames that the profiler did not trace; None
without span records or without such a run."""

from slambench.spans import untraced_frames


def read(run):
    records = getattr(run, "program", None)
    if run.kind != "frames" or not records:
        return None
    keep = set(untraced_frames(run))
    ns = [r.end_ns - r.start_ns for r in records
          if r.name == "ba.run" and r.frame in keep]
    return 1e-6 * sum(ns) / len(ns) if ns else None
