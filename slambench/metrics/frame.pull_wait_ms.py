"""Mean host wait at the frame's one batched pull
(`PinSLAMSystem.last_pull_block`), over the window's frames."""


def read(run):
    if run.kind != "frames" or not run.frames:
        return None
    return 1e3 * sum(f["pull_s"] for f in run.frames) / len(run.frames)
