"""The tracer (`pin_slam_tpu_torch/utils/tracing.py`) and the spans of the
frame loop, on the CPU at a small size.

* Off, `span` is one shared null context and records nothing; `stage`
  times its block either way.
* Five frames through `process_frame` under the cell probe and the join
  probe, with the loop manager as the loop hook (a closure is tried on the
  last frame) and the dataset layer's KITTI correction before each frame,
  once with the tracer off and once on: the poses, the map rows and the
  features are bit-equal.
* The traced run's spans nest as the modules say, carry their frame's id,
  and count what they stand for: one `tracker.iter` per GN iteration
  (`last_track_iters`), one `mapper.iter` per training iteration.
* `timings` and `last_pull_block` are the stage spans' durations.
* A span opened while `torch.profiler` records is a `pin_slam.<name>`
  range of the trace; without a profiler it opens none.
"""

import numpy as np
import pytest
import torch

from pin_slam_tpu_torch.config import Config
from pin_slam_tpu_torch.dataset.slam_dataset import intrinsic_correct
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions)
from pin_slam_tpu_torch.slam.loop import LoopPgoManager
from pin_slam_tpu_torch.slam.system import TIMING_COLUMNS, PinSLAMSystem
from pin_slam_tpu_torch.utils import tracing

N_FRAMES = 5
MAP_FIELDS = ("positions", "orientations", "geo_features", "ts_create",
              "ts_update", "certainty", "count")
# the parents each span is opened under (None: a root)
PARENT = {
    "frame": None,
    "frame.preprocess": "frame", "frame.odometry": "frame",
    "frame.map_update": "frame", "frame.prefetch": "frame",
    "frame.pull": "frame",
    "tracker.track": ("frame.odometry", "loop.register"),
    "tracker.iter": "tracker.track",
    "mapper.prune": "frame.map_update",
    "mapper.dynamic_filter": "frame.map_update",
    "mapper.frame_update": "frame.map_update",
    "mapper.pool_filter": "frame.map_update",
    "mapper.train": "frame", "mapper.setup": "mapper.train",
    "mapper.iter": "mapper.train", "mapper.loss": "mapper.iter",
    "mapper.backward": "mapper.iter", "mapper.step": "mapper.iter",
    "mapper.certainty": "mapper.iter", "mapper.writeback": "mapper.train",
    "loop.after_frame": "frame", "loop.descriptor": "loop.after_frame",
    "loop.graph": "loop.after_frame", "loop.detect": "loop.after_frame",
    "loop.close": "loop.after_frame", "loop.register": "loop.close",
    "loop.pgo": "loop.close", "loop.deform": "loop.close",
    "dataset.correct": None,
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def tracer_off():
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def small_config(mode):
    cfg = Config()
    cfg.track_on = True
    cfg.max_range = 60.0
    cfg.min_range = 0.5
    cfg.vox_down_m = 0.08
    cfg.source_vox_down_m = 0.4
    cfg.voxel_size_m = 0.3
    cfg.sigma_sigmoid_m = 0.1
    cfg.surface_sample_range_m = 0.25
    cfg.loss_weight_on = True
    cfg.bs = 512
    cfg.iters = 3
    cfg.init_iter_ratio = 20
    cfg.bs_new_sample = 128
    cfg.reg_iter_n = 20
    cfg.map_capacity = 1 << 16
    cfg.buffer_size = 1 << 18
    cfg.frame_point_cap = 1 << 13
    cfg.source_point_cap = 1 << 11
    cfg.local_set_cap = 1 << 16
    cfg.train_subset_hist = 1024
    cfg.max_frames = 16
    cfg.probe_mode = mode
    cfg.pgo_on = True
    cfg.pgo_freq = 1
    cfg.min_loop_travel_dist_ratio = 0.01
    cfg.silence = True
    cfg.finalize()
    cfg.pool_capacity = 100_000
    return cfg


@pytest.fixture(scope="module")
def seq():
    s = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(N_FRAMES + 1, radius=6.0, revolutions=0.03,
                                ease_in_frames=4),
        dirs=lidar_directions(512, 32), max_range=60.0)
    return s.poses, [s.frame(i) for i in range(N_FRAMES)]


def _run(seq, mode, traced):
    poses_gt, frames = seq
    cfg = small_config(mode)
    system = PinSLAMSystem(cfg, device="cpu")
    system.set_gt_poses(poses_gt)
    loop_mgr = LoopPgoManager(cfg, system)
    if traced:
        tracing.enable()
    poses, gn_iters, train_iters = [], [], []
    try:
        for fid in range(N_FRAMES):
            # the synthetic sensor has no elevation error to correct
            pts = intrinsic_correct(frames[fid], 0.0)
            nxt = frames[fid + 1] if fid + 1 < N_FRAMES else None
            poses.append(system.process_frame(
                fid, pts, loop_hook=lambda f, _p=pts: loop_mgr.after_frame(
                    f, _p), next_points=nxt))
            gn_iters.append(max(system.last_track_iters, 0))
            train_iters.append(len(system.last_train_losses))
    finally:
        tracing.disable()
    return dict(system=system, poses=np.stack(poses), gn_iters=gn_iters,
                train_iters=train_iters, records=tracing.drain())


@pytest.fixture(scope="module")
def runs(seq):
    tracing.disable()
    tracing.drain()
    return {(mode, traced): _run(seq, mode, traced)
            for mode in ("cells", "join") for traced in (False, True)}


def test_off_span_is_the_shared_null_context():
    assert not tracing.TRACER.on
    a, b = tracing.span("frame.pull"), tracing.span("mapper.iter")
    assert a is b
    with tracing.frame(3):
        with a:
            with tracing.stage("frame.pull") as st:
                pass
    assert st.seconds >= 0.0
    assert tracing.TRACER.stage_s == {"frame.pull": st.seconds}
    assert tracing.drain() == []


def test_on_records_name_times_parent_and_frame():
    tracing.enable()
    with tracing.frame(7):
        with tracing.span("frame.odometry"):
            with tracing.stage("frame.pull"):
                pass
    with tracing.span("dataset.correct"):
        pass
    tracing.disable()
    rec = {r.name: r for r in tracing.drain()}
    assert set(rec) == {"frame", "frame.odometry", "frame.pull",
                        "dataset.correct"}
    assert rec["frame"].parent == -1 and rec["dataset.correct"].parent == -1
    assert rec["frame.pull"].parent == rec["frame.odometry"].id
    assert rec["frame.odometry"].parent == rec["frame"].id
    assert [rec[n].frame for n in ("frame", "frame.odometry",
                                   "frame.pull")] == [7, 7, 7]
    assert rec["dataset.correct"].frame is None
    for r in rec.values():
        assert r.start_ns <= r.end_ns


@pytest.mark.parametrize("mode", ["cells", "join"])
def test_the_tracer_changes_no_result(runs, mode):
    off, on = runs[(mode, False)], runs[(mode, True)]
    assert not off["records"] and on["records"]
    assert np.array_equal(off["poses"], on["poses"])
    for f in MAP_FIELDS:
        a = getattr(off["system"].state, f)
        b = getattr(on["system"].state, f)
        assert torch.equal(a, b), f
    for k in ("w", "b"):
        for a, b in zip(off["system"].params["geo_mlp"][k],
                        on["system"].params["geo_mlp"][k]):
            assert torch.equal(a, b)
    assert off["gn_iters"] == on["gn_iters"]


@pytest.mark.parametrize("mode", ["cells", "join"])
def test_the_span_tree_nests_and_carries_frame_ids(runs, mode):
    rec = runs[(mode, True)]["records"]
    by_id = {r.id: r for r in rec}
    names = {r.name for r in rec}
    assert names <= set(PARENT), names - set(PARENT)
    for must in ("frame", "frame.preprocess", "frame.odometry",
                 "frame.map_update", "frame.pull", "frame.prefetch",
                 "tracker.track", "tracker.iter", "mapper.train",
                 "mapper.setup", "mapper.iter", "mapper.loss",
                 "mapper.backward", "mapper.step", "mapper.writeback",
                 "mapper.frame_update", "loop.after_frame",
                 "loop.descriptor", "loop.graph", "loop.detect",
                 "dataset.correct"):
        assert must in names, must
    # the join probe's steady frames add the certainty once, after the
    # iterations (the first frame's long run adds it every iteration)
    cert = {r.frame for r in rec if r.name == "mapper.certainty"}
    assert cert == (set(range(N_FRAMES)) if mode == "cells" else {0})
    for r in rec:
        want = PARENT[r.name]
        if want is None:
            assert r.parent == -1, r
        else:
            p = by_id[r.parent]
            assert p.name in (want if isinstance(want, tuple) else (want,)),\
                (r.name, p.name)
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
        if r.name != "dataset.correct":
            assert r.frame is not None
            root = r
            while root.parent != -1:
                root = by_id[root.parent]
            assert root.name == "frame" and root.frame == r.frame
        else:
            assert r.frame is None
    assert sorted(r.frame for r in rec if r.name == "frame") == \
        list(range(N_FRAMES))


@pytest.mark.parametrize("mode", ["cells", "join"])
def test_iteration_spans_count_the_iterations(runs, mode):
    run = runs[(mode, True)]
    rec = run["records"]
    by_id = {r.id: r for r in rec}
    # the odometry's GN iterations, not a loop registration's
    odo = [r for r in rec if r.name == "tracker.iter"
           and by_id[by_id[r.parent].parent].name == "frame.odometry"]
    for fid in range(N_FRAMES):
        n_gn = sum(r.frame == fid for r in odo)
        n_tr = sum(r.name == "mapper.iter" and r.frame == fid for r in rec)
        assert n_gn == run["gn_iters"][fid]
        assert n_tr == run["train_iters"][fid]
    assert run["train_iters"][0] == 60 and run["gn_iters"][1] > 1


@pytest.mark.parametrize("mode", ["cells", "join"])
def test_timings_are_the_stage_spans(runs, mode):
    run = runs[(mode, True)]
    system = run["system"]
    assert len(system.timings) == N_FRAMES
    for fid in range(N_FRAMES):
        dur = {}
        for r in run["records"]:
            if r.frame == fid:
                dur[r.name] = dur.get(r.name, 0.0) + (
                    r.end_ns - r.start_ns) * 1e-9
        want = [sum(dur.get(n, 0.0) for n in col) for col in TIMING_COLUMNS]
        assert system.timings[fid] == pytest.approx(want, rel=1e-12)
        assert all(v > 0 for v in system.timings[fid])
    last_pull = [r for r in run["records"] if r.name == "frame.pull"][-1]
    assert system.last_pull_block == (last_pull.end_ns
                                      - last_pull.start_ns) * 1e-9
    # tracing off, the stage spans are timed all the same
    off = runs[(mode, False)]["system"].timings
    assert len(off) == N_FRAMES and all(v > 0 for row in off for v in row)


def test_a_profiled_span_is_a_named_range():
    tracing.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("mapper.step"):
            torch.ones(4).sum()
    with tracing.span("mapper.iter"):
        torch.ones(4).sum()
    tracing.disable()
    names = [e.name for e in prof.events()]
    assert "pin_slam.mapper.step" in names
    assert "pin_slam.mapper.iter" not in names
    assert [r.name for r in tracing.drain()] == ["mapper.step",
                                                 "mapper.iter"]
