"""Mean training iterations a window frame (`PinSLAMSystem.train`'s
`iters`, 0 where a frame does not train): the adaptive schedule's
`iters` -5 / +5 / +10 by the frame's share of new observations."""


def read(run):
    if run.kind != "frames" or not run.frames:
        return None
    return sum(f.get("train_iters", 0) for f in run.frames) / len(run.frames)
