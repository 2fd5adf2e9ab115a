"""Host ms a frame spent in the blocking runtime syncs that
`frame.host_syncs` counts, over the profiled stretch."""


def read(run):
    tr = run.trace
    if run.kind != "frames" or tr is None or not tr.get("steps") \
            or not tr.get("syncs"):
        return None
    return 1e3 * tr["syncs"]["seconds"] / tr["steps"]
