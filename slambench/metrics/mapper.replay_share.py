"""Share of the window's training iterations (the program's `mapper.iter`
spans) that replayed a captured iteration (`mapper.replay` spans inside
them), in %, over every frame of the window; None without span records."""


def read(run):
    records = getattr(run, "program", None)
    if run.kind != "frames" or not records or not run.frames:
        return None
    keep = {f["fid"] for f in run.frames}
    iters = replays = 0
    for r in records:
        if r.frame in keep:
            iters += r.name == "mapper.iter"
            replays += r.name == "mapper.replay"
    return 100.0 * replays / iters if iters else None
