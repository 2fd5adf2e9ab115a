"""Blocking runtime syncs a frame (cudaStreamSynchronize,
cudaDeviceSynchronize, cudaEventSynchronize) inside the program's `frame`
spans, over the profiled stretch."""


def read(run):
    tr = run.trace
    if run.kind != "frames" or tr is None or not tr.get("steps") \
            or not tr.get("syncs"):
        return None
    return tr["syncs"]["count"] / tr["steps"]
