"""Host ms a frame in `LoopPgoManager.after_frame` (the program's
`loop.after_frame` span), over the window's frames that the profiler did
not trace."""

from slambench.spans import mean_span_ms


def read(run):
    if run.kind != "frames":
        return None
    return mean_span_ms(run, "loop.after_frame")
