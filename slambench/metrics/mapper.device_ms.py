"""Device ms a frame of the kernels launched under the benchmark's range
round `PinSLAMSystem.train`, over the traced stretch."""


def read(run):
    tr = run.trace
    if run.kind != "frames" or tr is None or not tr.get("steps"):
        return None
    s = tr.get("layers_device_s", {}).get("slambench.mapper")
    return None if not s else 1e3 * s / tr["steps"]
