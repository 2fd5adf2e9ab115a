"""Host ms a frame in `PinSLAMSystem.train` (the program's `mapper.train`
span: the host's enqueue of the training run, beside the device time of
`mapper.device_ms`), over the window's frames that the profiler did not
trace."""

from slambench.spans import mean_span_ms


def read(run):
    if run.kind != "frames":
        return None
    return mean_span_ms(run, "mapper.train")
