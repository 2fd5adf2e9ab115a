"""Device operations the profiler saw, per frame of the traced stretch."""


def read(run):
    tr = run.trace
    if run.kind != "frames" or tr is None or not tr.get("steps"):
        return None
    return tr["n_kernels"] / tr["steps"]
