"""Frames whose pose came back in the window, over the time from the
window's start to the end of the last of them (closed by a device sync, so
the last frame's lagged training counts)."""


def read(run):
    if run.kind != "frames" or not run.frames:
        return None
    return len(run.frames) / run.window_s
