"""Kernel launches a frame made under the program's `mapper.train` span
and the spans inside it (runtime launch calls from any thread, put down by
time to the innermost span), over the profiled stretch."""

from slambench.spans import MAPPER_TRAIN


def read(run):
    tr = run.trace
    if run.kind != "frames" or tr is None or not tr.get("steps") \
            or not tr.get("launches_by_span"):
        return None
    by_span = tr["launches_by_span"]
    return sum(by_span.get(n, 0) for n in MAPPER_TRAIN) / tr["steps"]
