"""Share of the traced stretch of frames with no kernel, copy or set on
the card (torch.profiler)."""


def read(run):
    tr = run.trace
    if run.kind != "frames" or tr is None or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
