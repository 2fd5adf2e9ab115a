"""Mean host ms of the window's bundle-adjustment frames (the frames whose
`ba` flag the harness set: every `ba_freq_frame`-th), from the start of
the frame's dataset-layer work to `process_frame`'s return; None in a
window without one."""


def read(run):
    if run.kind != "frames":
        return None
    walls = [f["wall_s"] for f in run.frames if f.get("ba")]
    return 1e3 * sum(walls) / len(walls) if walls else None
