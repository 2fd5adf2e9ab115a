"""Nearest-rank 90th percentile, over every frame of the window, of the
host time from the start of the frame's dataset-layer work to
`process_frame`'s return."""

from slambench.yardstick import p90


def read(run):
    if run.kind != "frames" or not run.frames:
        return None
    return 1e3 * p90([f["wall_s"] for f in run.frames])
