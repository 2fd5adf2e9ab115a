"""The program's spans read against a trace (`spans.attribute`) on a
hand-made event list, the span readers on hand-made runs, and a small CPU
run under `spans.traced_harness`."""

import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import harness as H  # noqa: E402
from slambench import spans  # noqa: E402

NEW = [n for n, _ in spans.NEW_METRICS]


def _ev(name, t0, t1, cuda=False, thread=1, annotation=False):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=t0, end=t1),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        is_user_annotation=annotation, thread=thread)


def _events():
    """A window 0-1000 us; one frame 100-900 holding the tracker (100-300,
    one GN iteration 150-250 inside it) and training (400-800); kernels at
    200-210 and 500-600; the dataset layer at 20-60 before the frame."""
    return [
        _ev("slambench.window", 0, 1000),
        _ev("pin_slam.dataset.correct", 20, 60),
        _ev("pin_slam.frame", 100, 900),
        _ev("pin_slam.frame.odometry", 100, 300),
        _ev("pin_slam.tracker.track", 100, 300),
        _ev("pin_slam.tracker.iter", 150, 250),
        _ev("pin_slam.mapper.train", 400, 800),
        # the device side of the ranges: no work
        _ev("pin_slam.mapper.train", 500, 600, cuda=True, annotation=True),
        _ev("slambench.mapper", 500, 600, cuda=True),
        _ev("void k<{lambda(int)#1}>(int)", 200, 210, cuda=True),
        _ev("kernel_b", 500, 600, cuda=True),
        # launches: one from the frame loop's thread inside the GN
        # iteration (the `cuLaunchKernel` inside it is the same launch), two
        # from autograd's thread while training waits (one a `cuLaunch*`
        # call alone, as a Triton kernel makes it), one between frames
        _ev("cudaLaunchKernel", 190, 195),
        _ev("cuLaunchKernel", 191, 193),
        _ev("cudaLaunchKernel", 480, 485, thread=2),
        _ev("cuLaunchKernelEx", 490, 492, thread=2),
        _ev("cudaLaunchKernel", 950, 955),
        # syncs: one in the GN iteration, one between frames
        _ev("cudaStreamSynchronize", 240, 248),
        _ev("cudaDeviceSynchronize", 960, 990),
    ]


def test_idle_time_goes_to_the_innermost_span_of_each_moment():
    out = spans.attribute(_events())
    idle = out["idle_by_span"]
    # gaps 0-200, 210-500 and 600-1000, split where the host's innermost
    # span changes: outside 0-20, 60-100, 900-1000; the dataset layer
    # 20-60; the tracker 100-150, 250-300; its GN iteration 150-200,
    # 210-250; the frame alone 300-400, 800-900; training 400-500, 600-800
    assert idle == pytest.approx({
        "outside": 160e-6, "dataset.correct": 40e-6,
        "tracker.track": 100e-6, "tracker.iter": 90e-6, "frame": 200e-6,
        "mapper.train": 300e-6})
    assert sum(idle.values()) == pytest.approx((1000 - 10 - 100) * 1e-6)
    assert out["device_busy_s"] == pytest.approx(110e-6)


def test_launches_from_another_thread_go_by_time():
    out = spans.attribute(_events())
    assert out["launches_by_span"] == {"tracker.iter": 1, "mapper.train": 2,
                                       "outside": 1}


def test_gaps_and_launches_under_no_span_go_outside():
    ev = [e for e in _events() if e.name != "pin_slam.frame"]
    ev += [_ev("kernel_c", 850, 1000, cuda=True)]
    out = spans.attribute(ev)
    # without the frame, 300-400 and 800-850 lie under no span too
    assert out["idle_by_span"]["outside"] == pytest.approx(210e-6)
    assert out["launches_by_span"]["outside"] == 1


def test_only_syncs_inside_frames_count():
    out = spans.attribute(_events())
    assert out["syncs"]["count"] == 1
    assert out["syncs_by_span"] == {"tracker.iter": 1}
    assert out["syncs"]["seconds"] == pytest.approx(8e-6)


def test_no_window_or_no_program_span_gives_nothing():
    ev = _events()
    assert spans.attribute([e for e in ev
                            if e.name != "slambench.window"]) == {}
    from torch.autograd import DeviceType
    assert spans.attribute([e for e in ev
                            if not e.name.startswith("pin_slam.")
                            or e.device_type == DeviceType.CUDA]) == {}


def test_painter_nests_and_reverts_to_the_parent():
    p = spans.Painter([(0, 10, "a"), (2, 4, "b"), (4, 6, "c"),
                       (6, 8, "d"), (7, 8, "e")])
    assert [p.at(t) for t in (-1, 1, 2, 3.9, 4, 5, 6, 7.5, 8, 9, 10)] == \
        [None, "a", "b", "b", "c", "c", "d", "e", "a", "a", None]
    parts = {}
    for name, d in p.split(-1, 11):
        parts[name] = parts.get(name, 0) + d
    assert parts == {None: 2, "a": 4, "b": 2, "c": 2, "d": 1, "e": 1}
    assert p.split(2.5, 3) == [("b", 0.5)]


def _run(n_frames=30, records=()):
    run = H.Run("frames")
    run.frames = [{"fid": 10 + i} for i in range(n_frames)]
    run.program = list(records)
    return run


def _rec(name, frame, ms, rid=0, parent=-1):
    from pin_slam_tpu_torch.utils.tracing import SpanRecord
    return SpanRecord(name, 0, int(ms * 1e6), rid, parent, frame)


def test_host_metrics_leave_out_the_profiled_frames():
    # window frames 10-39; the profiler traces 15-34: 10 frames are left
    traced = set(range(10 + H.TRACE_SKIP, 10 + H.TRACE_SKIP
                       + H.TRACE_FRAMES))
    rec = [_rec("loop.after_frame", f, 50.0 if f in traced else 20.0)
           for f in range(10, 40)]
    run = _run(records=rec)
    assert spans.untraced_frames(run) == [f for f in range(10, 40)
                                          if f not in traced]
    assert H.load_metric("loop.host_ms").read(run) == pytest.approx(20.0)
    assert H.load_metric("tracker.host_ms").read(run) == 0.0


def test_first_frame_and_trace_readers():
    run = _run(records=[_rec("frame", 0, 4200.0), _rec("frame", 1, 90.0)])
    assert H.load_metric("setup.first_frame_s").read(run) == \
        pytest.approx(4.2)
    run.trace = {"steps": 4, "syncs": {"count": 36, "seconds": 0.02},
                 "launches_by_span": {"mapper.train": 10, "mapper.iter": 30,
                                      "mapper.frame_update": 99,
                                      "mapper.backward": 40}}
    assert H.load_metric("frame.host_syncs").read(run) == 9.0
    assert H.load_metric("frame.sync_wait_ms").read(run) == \
        pytest.approx(5.0)
    assert H.load_metric("mapper.launches").read(run) == 20.0


def test_host_split_self_time():
    from pin_slam_tpu_torch.utils.tracing import SpanRecord
    rec = [_rec("frame", 10, 100.0, rid=1),
           _rec("mapper.train", 10, 60.0, rid=2, parent=1),
           _rec("mapper.iter", 10, 50.0, rid=3, parent=2),
           # between frames: before frame 10, and after it (frame 11's)
           SpanRecord("dataset.correct", -5, -1, 4, -1, None),
           SpanRecord("dataset.correct", int(2e8), int(2e8) + 5, 5, -1,
                      None)]
    run = _run(n_frames=1, records=rec)
    split = spans.host_split(run)
    assert split["ms"]["dataset.correct"] == pytest.approx([4e-6, 4e-6])
    assert split["ms"]["frame"] == pytest.approx([100.0, 40.0])
    assert split["ms"]["mapper.train"] == pytest.approx([60.0, 10.0])
    assert split["frame_self_share"] == pytest.approx(0.4)
    assert spans.idle_coverage({"idle_by_span": {
        "outside": 1.0, "frame": 1.0, "mapper.iter": 6.0,
        "dataset.correct": 2.0}}) == pytest.approx(0.8)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_with_nothing_to_read_return_nothing(name):
    reader = H.load_metric(name)
    run = H.Run("frames")
    assert reader.read(run) is None
    run.frames = [{"fid": i, "wall_s": 0.1} for i in range(40)]
    run.trace = {"busy_s": 0.1, "window_s": 1.0, "steps": 20,
                 "n_kernels": 10}
    assert reader.read(run) is None


def test_a_small_run_under_the_traced_harness_reads_the_host_metrics():
    import torch
    from slambench.tests import small
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with spans.traced_harness() as runs:
            res = small.run_small(Path(tempfile.mkdtemp()),
                                  "kitti_cells.drive", trace=True)
    finally:
        torch.set_num_threads(n)
    assert H.run_frames.__name__ == "run_frames" and \
        H.run_frames.__module__ == "slambench.harness"
    (run,) = runs
    m = res["metrics"]
    for name in ("loop.host_ms", "tracker.host_ms", "mapper.dispatch_ms",
                 "setup.first_frame_s"):
        assert m[name]["value"] > 0, name
    # a CPU run has no device trace to read
    for name in ("mapper.launches", "frame.host_syncs",
                 "frame.sync_wait_ms"):
        assert name not in m
    split = spans.summary(run)["host_split"]
    assert split["frame_self_share"] < 0.1
    assert m["mapper.dispatch_ms"]["value"] == pytest.approx(
        split["ms"]["mapper.train"][0])
