"""Host ms a frame in the tracker's registrations (the program's
`tracker.track` span), over the window's frames that the profiler did not
trace."""

from slambench.spans import mean_span_ms


def read(run):
    if run.kind != "frames":
        return None
    return mean_span_ms(run, "tracker.track")
