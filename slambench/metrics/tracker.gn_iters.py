"""Mean Gauss-Newton iterations a frame (`PinSLAMSystem.last_track_iters`)."""


def read(run):
    if run.kind != "frames" or not run.frames:
        return None
    return sum(f["gn_iters"] or 0 for f in run.frames) / len(run.frames)
