"""Host seconds of the run's first frame (the program's `frame` span of
frame 0: its long first training run and the pull), a part of
`setup_s`."""


def read(run):
    records = getattr(run, "program", None)
    if run.kind != "frames" or not records:
        return None
    first = [r for r in records if r.name == "frame" and r.frame == 0]
    return (first[0].end_ns - first[0].start_ns) * 1e-9 if first else None
