"""The model FLOPs of the window's frames (training: iterations run x
batch, forward and backward; registration: Gauss-Newton iterations run x
source points, forward and gradient; counted by `yardstick`) over the
window's time, against the card's float32 peak."""

from slambench import yardstick as Y


def read(run):
    if run.kind != "frames" or not run.frames:
        return None
    st = run.settings
    flops = sum(Y.train_flops(st, f["train_iters"], run.bs)
                + Y.track_flops(st, f["gn_iters"] or 0, f["src_n"])
                for f in run.frames)
    return 100.0 * flops / run.window_s / Y.PEAK_FP32_FLOPS
