"""The port's loop closure (pin_slam_tpu_torch.slam.loop) against the JAX
package's, at a small size on the CPU.

Scenario: a drifted revisit (1.3 laps of a 6 m circle in 16 steps of
~3.6 m, of which the first 14 frames run: the closure comes at frame 12). Scans are ray-cast from the TRUE poses while both systems run in
mapping mode on DRIFTED poses, so the map is the scene warped by the drift
and a closure has something to correct (the scenario of the JAX package's
own closure test, with fewer, longer steps).

* `_close_loop`, deterministic: the JAX run's state just before its
  closure (map, pool, decoder, poses, travel, pose graph) is carried into
  the port and both close the same loop. The refined loop edge agrees
  within one termination step of the GN (1 mm / 0.01 deg: where a float
  sum rounds the other way, one run takes one more step); given the JAX
  registration's refined pose, the PGO poses, the deformed map and the
  pool agree to 1e-5 and the rehashed table exactly; the boost and
  after-PGO flags exactly. The first training after the closure (boosted, on a local set
  that now carries orientations) gives the JAX losses with the same draws:
  the first two iterations to 1e-5, the run to 1e-3.
* The consequences alone: the JAX closure's own per-frame corrections
  applied by the port to the same state give the deformed positions and
  orientations to 1e-6, the rehashed table exactly and the pool to 1e-6.
* The local-map context (`map_context`, `loop_with_feature`) on the JAX
  run's final state: the points and features around a frame, the
  fallback to every live point, and `after_frame`'s descriptor nodes and
  global candidates in context mode equal the JAX package's.
* `after_frame` end to end, statistical: both systems run the revisit
  through `process_frame(loop_hook=...)` from the same initial decoder,
  each with its own random draws (ray samples, training batches). Each
  closes one loop with the same loop id; the PGO poses agree within
  MAX_DT / MAX_DA and meet the JAX closure test's own trajectory gate.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.slam.loop import LoopPgoManager as JLoop
from pin_slam_tpu.slam.system import PinSLAMSystem as JSystem
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions)
from pin_slam_tpu_torch.slam.loop import LoopPgoManager as TLoop
from pin_slam_tpu_torch.slam.system import PinSLAMSystem as TSystem
from pin_slam_tpu_torch.utils.eval_traj import absolute_error

N_STEPS = 16             # the trajectory: 1.3 laps in 16 steps
N = 14                   # frames run: the closure comes at frame 12
# Pose bounds of the end-to-end comparison. At this scan density the loop
# registration is noisy: the PGO pose of the closure frame lies 11-19 cm
# from ground truth over six JAX keys and 10-22 cm over eight port
# generator seeds (scripts/loop_closure_spread.py), so two runs of either
# package may land 7 cm or more apart there. A 5 cm bar would fail the
# reference against itself; 15 cm / 0.5 deg holds for both.
MAX_DT, MAX_DA = 0.15, 0.5
HOST = ("pgo_poses", "odom_poses", "travel_dist", "cur_pose_ref",
        "last_pose_ref", "last_odom_tran", "lose_track", "stop_status",
        "reboot_ts", "decoder_freezed", "post_loop_iter_boost_pending",
        "after_pgo", "_map_deformed")


@contextlib.contextmanager
def torch_threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    with torch_threads(1):
        yield


def loop_config(cls):
    cfg = cls()
    cfg.track_on = False
    cfg.pgo_on = True
    cfg.max_range = 60.0
    cfg.min_range = 0.5
    cfg.vox_down_m = 0.12
    cfg.voxel_size_m = 0.3
    cfg.sigma_sigmoid_m = 0.05
    cfg.surface_sample_range_m = 0.25
    cfg.bs = 2048
    cfg.iters = 5
    cfg.init_iter_ratio = 10
    cfg.bs_new_sample = 512
    cfg.reg_iter_n = 30
    cfg.map_capacity = 1 << 16
    cfg.buffer_size = 1 << 19
    cfg.frame_point_cap = 1 << 13
    cfg.source_point_cap = 1 << 11
    cfg.max_frames = 32
    cfg.local_set_cap = 1 << 16
    cfg.train_subset_hist = 2048
    cfg.probe_mode = "join"
    cfg.pgo_freq = 8
    cfg.post_loop_iter_boost = 12
    cfg.finalize()
    cfg.pool_capacity = 300_000
    cfg.local_map_travel_dist_ratio = 0.4
    cfg.min_loop_travel_dist_ratio = 0.45
    cfg.use_mid_ts = True
    return cfg


@pytest.fixture(scope="module")
def scenario():
    gt = circle_trajectory(N_STEPS, radius=6.0, revolutions=1.3,
                           ease_in_frames=4)[:N]
    drifted = gt.copy()
    for i in range(1, N):
        # body-frame drift: 0.17 m / 2.6 deg at the revisit
        th = 0.004 * i
        D = np.eye(4)
        D[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        D[0, 3] = 0.012 * i
        drifted[i] = gt[i] @ D
    seq = SyntheticSequence(scene_sdf=default_scene(half_extent=(16.0, 12.0,
                                                                 4.0)),
                            poses=gt, dirs=lidar_directions(256, 16),
                            max_range=60.0)
    return gt, drifted, [seq.frame(i) for i in range(N)]


def _snapshot(js, jm):
    return dict(
        state={f: np.asarray(getattr(js.state, f))
               for f in convert.STATE_FIELDS},
        pool={f: np.asarray(getattr(js.pool, f)) for f in convert.POOL_FIELDS},
        geo_mlp=jax.tree.map(np.asarray, js.params["geo_mlp"]),
        host={k: copy.deepcopy(getattr(js, k)) for k in HOST},
        pgm=copy.deepcopy({k: v for k, v in jm.pgm.__dict__.items()
                           if k != "config"}),
        loop_reg_failed_count=jm.loop_reg_failed_count)


def _jax_boosted_training(js, frame_id):
    """The JAX system's first training after the closure (iters + boost),
    run functionally, so the system itself is left as it was. Returns the
    key, the pool counts it drew from, and the losses."""
    c = js.config
    iters = c.iters + js.post_loop_iter_boost_pending
    loop = js._get_train_loop(iters, not js.decoder_freezed)
    mlp = {k: v for k, v in js.params.items() if k != "geo_features"}
    use_new = jnp.bool_(not (js.lose_track or js.stop_status))
    out = loop(mlp, js.opt_state, js.state, js.pool, js.key,
               js._lf(frame_id), use_new, jnp.int32(js.reboot_ts))
    return dict(iters=iters, key=js.key, pool_count=int(js.pool.count),
                new_count=int(js.pool.new_count), use_new=bool(use_new),
                losses=np.asarray(out[4]))


@pytest.fixture(scope="module")
def jax_run(scenario):
    gt, drifted, frames = scenario
    cfg = loop_config(JConfig)
    js = JSystem(cfg)
    js.set_gt_poses(drifted)
    jm = JLoop(cfg, js)
    rec = {"pending": [],
           "init_mlp": jax.tree.map(np.asarray, js.params["geo_mlp"])}
    real_close = jm._close_loop

    def close(frame_id, loop_id, T, points):
        rec["before"] = _snapshot(js, jm)
        rec["args"] = (frame_id, loop_id, np.array(T))
        ok = real_close(frame_id, loop_id, T, points)
        rec["ok"] = ok
        rec["after"] = _snapshot(js, jm)
        if ok:
            rec["diffs"] = jm.pgm.get_pose_diff()
            rec["train"] = _jax_boosted_training(js, frame_id)
        return ok

    jm._close_loop = close
    for fid in range(N):
        js.process_frame(fid, frames[fid],
                         loop_hook=lambda f, _p=frames[fid]:
                         jm.after_frame(f, _p))
        rec["pending"].append(js.post_loop_iter_boost_pending)
    rec["pgo_poses"] = js.pgo_poses[:N].copy()
    rec["pgo_count"] = jm.pgo_count
    rec["loops"] = [tuple(int(v) for v in e) for e in jm.pgm.loop_edges]
    rec["final"] = _snapshot(js, jm)
    rec["system"] = js
    assert rec.get("ok"), "the JAX package closed no loop on the revisit"
    return rec


def _port_from_snapshot(snap, device="cpu"):
    cfg = loop_config(TConfig)
    ts = TSystem(cfg, device=device)
    ts.state = convert.state_from_numpy(snap["state"], device)
    ts.pool = convert.pool_from_numpy(snap["pool"], device)
    ts.params = {"geo_features": ts.state.geo_features,
                 "geo_mlp": convert.mlp_from_numpy(snap["geo_mlp"], device)}
    for k, v in snap["host"].items():
        setattr(ts, k, copy.deepcopy(v))
    tm = TLoop(cfg, ts)
    tm.pgm.__dict__.update(copy.deepcopy(snap["pgm"]))
    tm.loop_reg_failed_count = snap["loop_reg_failed_count"]
    return ts, tm


def _jax_draws(key, n_iters, subset_hist, bs, bs_new, pool_count,
               new_count):
    """The JAX training loop's index draws, from its key schedule."""
    keys = jax.random.split(key, n_iters + 2)
    if n_iters <= 32 and subset_hist >= bs:
        S_h = max(bs, min(subset_hist, n_iters * bs))
        hist = jax.random.randint(keys[1], (S_h,), 0, max(pool_count, 1))
        sel = [jax.random.randint(jax.random.split(k)[0], (bs_new,), 0,
                                  max(new_count, 1)) for k in keys[2:]]
    else:
        hist, sel = [], []
        for k in keys[2:]:
            k1, k2 = jax.random.split(jax.random.split(k)[0])
            hist.append(jax.random.randint(k1, (bs,), 0, max(pool_count, 1)))
            sel.append(jax.random.randint(k2, (bs_new,), 0,
                                          max(new_count, 1)))
        hist = jnp.stack(hist)
    return {"hist": torch.as_tensor(np.array(hist)).long(),
            "new_sel": torch.as_tensor(np.array(jnp.stack(sel))).long()}


def _angle_deg(Ra, Rb):
    """Angle between two rotations from the skew part of Ra^T Rb: the
    trace formula loses its precision near zero, where float32-made
    rotations are a few 1e-8 off orthonormal."""
    R = Ra.T @ Rb
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.degrees(np.arcsin(min(np.linalg.norm(w) / 2, 1.0))))


@pytest.fixture(scope="module")
def port_close(jax_run, scenario):
    """The port's whole closure, its own loop registration included, on the
    JAX run's pre-closure state."""
    _, _, frames = scenario
    ts, tm = _port_from_snapshot(jax_run["before"])
    frame_id, loop_id, T = jax_run["args"]
    ok = tm._close_loop(frame_id, loop_id, T.copy(), frames[frame_id])
    return ts, tm, ok


@pytest.fixture(scope="module")
def port_close_jax_edge(jax_run, scenario):
    """The port's closure on the same state with the JAX registration's
    refined pose in place of its own: the gate, the graph solve and the
    consequences, held apart from the registration's termination step."""
    _, _, frames = scenario
    ts, tm = _port_from_snapshot(jax_run["before"])
    frame_id, loop_id, T = jax_run["args"]
    pose = jax_run["before"]["host"]["pgo_poses"][loop_id] \
        @ jax_run["after"]["pgm"]["loop_trans"][-1]
    tm._register = lambda *_: (True, pose, np.eye(6, dtype=np.float32),
                               0.0, 0)
    ok = tm._close_loop(frame_id, loop_id, T.copy(), frames[frame_id])
    return ts, tm, ok


def test_close_loop_refined_edge(jax_run, port_close):
    """The port's loop registration refines the edge to the JAX package's
    within one termination step of the GN (1 mm, 0.01 deg): both stop at
    the first step below it, and where one float sum rounds the other way
    one run takes one more step than the other (7.3e-4 m at one torch
    thread, 3.5e-6 m at four; scripts/loop_close_threads.py). The PGO
    poses, which spread the edge over the chain, move no more than it."""
    ts, tm, ok = port_close
    assert ok
    c = ts.config
    after = jax_run["after"]["pgm"]
    je, te = after["loop_trans"][-1], tm.pgm.loop_trans[-1]
    dt = np.linalg.norm(je[:3, 3] - te[:3, 3])
    assert dt <= c.reg_term_thre_m
    assert _angle_deg(je[:3, :3], te[:3, :3]) <= c.reg_term_thre_deg
    np.testing.assert_array_equal(tm.pgm.loop_edges[-1],
                                  after["loop_edges"][-1])
    assert tm.pgm.pgo_count == after["pgo_count"]
    n = jax_run["args"][0] + 1
    assert np.abs(after["pgo_poses"][:n, :3, 3]
                  - tm.pgm.pgo_poses[:n, :3, 3]).max() <= dt


def test_close_loop_pgo_poses_and_map(jax_run, port_close_jax_edge):
    """Given the JAX registration's refined pose, the graph solve, the
    deformation, the rehash and the pool transform after the closure: PGO
    poses, map positions and orientations and pool rows to 1e-5, the
    rehashed table exactly."""
    ts, tm, ok = port_close_jax_edge
    assert ok
    after = jax_run["after"]
    n = jax_run["args"][0] + 1
    jp, tp = after["pgm"]["pgo_poses"][:n], tm.pgm.pgo_poses[:n]
    assert np.abs(jp[:, :3, 3] - tp[:, :3, 3]).max() <= 1e-5
    assert max(_angle_deg(a[:3, :3], b[:3, :3])
               for a, b in zip(jp, tp)) <= 1e-3
    np.testing.assert_array_equal(ts.pgo_poses[:n], tp)
    cnt = int(after["state"]["count"])
    assert int(ts.state.count) == cnt
    np.testing.assert_allclose(ts.state.positions[:cnt].numpy(),
                               after["state"]["positions"][:cnt], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(ts.state.orientations[:cnt].numpy(),
                               after["state"]["orientations"][:cnt],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ts.state.table.numpy(),
                                  after["state"]["table"])
    P = int(after["pool"]["count"])
    np.testing.assert_allclose(ts.pool.coord[:P].numpy(),
                               after["pool"]["coord"][:P], atol=1e-5, rtol=0)


def test_close_loop_flags(jax_run, port_close):
    ts, _, _ = port_close
    after = jax_run["after"]["host"]
    for k in ("post_loop_iter_boost_pending", "after_pgo", "_map_deformed"):
        assert getattr(ts, k) == after[k], k
    assert ts.post_loop_iter_boost_pending == 12
    assert ts._cur_lset is None
    np.testing.assert_array_equal(ts.cur_pose_ref, ts.pgo_poses[
        jax_run["args"][0]])


@pytest.mark.parametrize("corrections", ["solved", "inverted", "shifted"])
def test_chip_smoke_closure_check(jax_run, scenario, corrections):
    """chip_smoke's `[loop]` check of a closure (check_closure on what
    record_closures kept), on the port's closure of the carried state:
    it passes the closure as the solve made it and catches corrections
    applied with the wrong sign or to the wrong frames."""
    import chip_smoke as cs
    _, _, frames = scenario
    ts, tm = _port_from_snapshot(jax_run["before"])
    solved = tm.pgm.get_pose_diff
    if corrections == "inverted":
        tm.pgm.get_pose_diff = lambda: np.linalg.inv(solved())
    elif corrections == "shifted":
        tm.pgm.get_pose_diff = lambda: np.roll(solved(), 3, axis=0)
    records = cs.record_closures(tm, torch.device("cpu"))
    frame_id, loop_id, T = jax_run["args"]
    assert tm._close_loop(frame_id, loop_id, T.copy(), frames[frame_id])
    c = cs.check_closure(records[0], ts.config.use_mid_ts)
    assert c["map_err"] <= cs.DEFORM_ATOL_M
    assert c["pool_err"] <= cs.DEFORM_ATOL_M and c["pool_rows"] > 1000
    assert c["rot_err"] <= cs.DEFORM_ROT_ATOL and c["moved_rows"] > 1000
    assert c["gap_after"] <= cs.LOOP_EDGE_PULL * c["gap_before"]
    assert (c["correction_err"] <= cs.CORRECTION_ATOL) == \
        (corrections == "solved"), c["correction_err"]


@pytest.fixture(scope="module")
def port_consequences(jax_run):
    """The JAX closure's per-frame corrections, applied by the port to the
    same pre-closure state."""
    ts, tm = _port_from_snapshot(jax_run["before"])
    tm._apply_deformation(
        torch.as_tensor(jax_run["diffs"].astype(np.float32)),
        jax_run["args"][0])
    ts.post_loop_iter_boost_pending = \
        jax_run["after"]["host"]["post_loop_iter_boost_pending"]
    return ts


def test_deformation_consequences_exact(jax_run, port_consequences):
    """Deformed map to 1e-6, the rehashed table exactly, the pool to 1e-6."""
    ts = port_consequences
    after = jax_run["after"]
    cnt = int(after["state"]["count"])
    assert cnt > 1000
    np.testing.assert_allclose(ts.state.positions.numpy(),
                               after["state"]["positions"], atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(ts.state.orientations.numpy(),
                               after["state"]["orientations"], atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(ts.state.table.numpy(),
                                  after["state"]["table"])
    np.testing.assert_allclose(ts.pool.coord.numpy(), after["pool"]["coord"],
                               atol=1e-6, rtol=0)
    assert ts._map_deformed and ts._cur_lset is None


def test_boosted_training_after_close(jax_run, port_consequences):
    """The first training after the closure runs iters + boost iterations
    on a local set that carries the orientations. With the same draws, the
    first two iterations' losses (the decode of the deformed map before any
    update, and after one Adam step) are the JAX package's to 1e-5. Later
    iterations drift apart by float rounding through Adam: the same 17
    iterations on the undeformed pre-closure state drift by up to 4.6e-4
    relative, so the whole run is held to 1e-3."""
    ts = port_consequences
    jt = jax_run["train"]
    c = ts.config
    draws = _jax_draws(jt["key"], jt["iters"], c.train_subset_hist, c.bs,
                       c.bs_new_sample, jt["pool_count"], jt["new_count"])
    assert int(ts.pool.count) == jt["pool_count"]
    assert (not (ts.lose_track or ts.stop_status)) == jt["use_new"]
    frame_id = jax_run["args"][0]
    lset = ts.build_lset_train(
        ts._tensor(ts.travel_dist[: ts.max_frames]), frame_id, ts.reboot_ts)
    assert lset.quat is not None
    assert jt["iters"] == c.iters + ts.post_loop_iter_boost_pending
    ts.train(jt["iters"], frame_id, draws=draws)
    losses = ts.last_train_losses.numpy()
    np.testing.assert_allclose(losses[:2], jt["losses"][:2], rtol=1e-5)
    np.testing.assert_allclose(losses, jt["losses"], rtol=1e-3)


@pytest.fixture(scope="module")
def port_run(scenario, jax_run):
    gt, drifted, frames = scenario
    cfg = loop_config(TConfig)
    ts = TSystem(cfg, device="cpu")
    ts.set_gt_poses(drifted)
    # both systems start from the JAX system's initial decoder
    ts.params["geo_mlp"] = convert.mlp_from_numpy(jax_run["init_mlp"],
                                                  device="cpu")
    tm = TLoop(cfg, ts)
    pending = []
    for fid in range(N):
        ts.process_frame(fid, frames[fid],
                         loop_hook=lambda f, _p=frames[fid]:
                         tm.after_frame(f, _p))
        pending.append(ts.post_loop_iter_boost_pending)
    return ts, tm, pending


def test_after_frame_closes_the_same_loop(jax_run, port_run):
    ts, tm, pending = port_run
    loops = [tuple(int(v) for v in e) for e in tm.pgm.loop_edges]
    assert tm.pgo_count == jax_run["pgo_count"] == 1
    assert loops == jax_run["loops"]
    # the boost is scheduled at the closure and consumed by the next frame
    k = loops[0][1]
    assert pending[k] == jax_run["pending"][k] == 12
    assert pending[k + 1] == jax_run["pending"][k + 1] == 0
    assert bool((ts.state.orientations[: int(ts.state.count), 1:]
                 != 0).any())


def test_after_frame_pgo_poses(scenario, jax_run, port_run):
    gt, drifted, _ = scenario
    ts, _, _ = port_run
    jp, tp = jax_run["pgo_poses"], ts.pgo_poses[:N]
    dt = np.linalg.norm(jp[:, :3, 3] - tp[:, :3, 3], axis=1)
    da = [_angle_deg(a[:3, :3], b[:3, :3]) for a, b in zip(jp, tp)]
    assert dt.max() < MAX_DT and max(da) < MAX_DA, (dt.max(), max(da))
    # the JAX closure test's trajectory gate, on both
    ate_drift, _ = absolute_error(gt, drifted, False)
    for p in (jp, tp):
        ate, _ = absolute_error(gt, p, False)
        assert np.isfinite(ate) and ate < 2.0 * ate_drift + 0.05


def context_config(cls):
    """loop_config with the local-map context as eight shipped configs set
    it (`map_context`, `loop_with_feature`), a 2-frame latency, the
    travel-distance window and an 8 m radius (both cut the small map), and
    no local candidates, so a candidate can only come from the global,
    context-based detector."""
    cfg = loop_config(cls)
    cfg.local_map_context = True
    cfg.loop_with_feature = True
    cfg.global_loop_on = True
    cfg.local_map_context_latency = 2
    cfg.loop_local_map_by_travel_dist = True
    cfg.local_map_radius = 8.0
    cfg.local_loop_dist_thre = 0.0
    cfg.pgo_freq = 0
    return cfg


@pytest.fixture(scope="module")
def context_pair(jax_run):
    """The JAX system at the end of its run and the port carrying its
    state, each with a loop manager in context mode whose closures are
    recorded instead of run (so neither state changes)."""
    js = jax_run["system"]
    ts, _ = _port_from_snapshot(jax_run["final"])
    jm, tm = JLoop(context_config(JConfig), js), \
        TLoop(context_config(TConfig), ts)
    for m in (jm, tm):
        m.calls = []
        m._close_loop = (lambda f, l, T, p, _m=m:
                         _m.calls.append((f, l, np.array(T))) or False)
    return js, jm, ts, tm


@pytest.mark.parametrize("lm_fid", [3, 9, 13, "far"])
def test_local_map_context(context_pair, lm_fid):
    """The neural points and features around a frame's pose (the
    travel-distance window and the radius cut the map), and the fallback
    to every live point when fewer than 100 remain (the pose moved 1 km
    away): the port gives the JAX package's arrays exactly."""
    js, jm, ts, tm = context_pair
    fid = 5 if lm_fid == "far" else lm_fid
    saved = js.pgo_poses[fid].copy(), ts.pgo_poses[fid].copy()
    if lm_fid == "far":
        js.pgo_poses[fid, 0, 3] += 1000.0
        ts.pgo_poses[fid, 0, 3] += 1000.0
    try:
        jp, jf, jpose = jm._local_map_context(fid)
        tp, tf, tpose = tm._local_map_context(fid)
    finally:
        js.pgo_poses[fid], ts.pgo_poses[fid] = saved
    cnt = int(ts.state.count)
    if lm_fid == "far":
        assert tp.shape[0] == cnt
    else:
        assert 100 <= tp.shape[0] < cnt
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tpose, jpose)


def test_after_frame_map_context_nodes(context_pair, scenario):
    """after_frame in context mode on the same state: every frame's
    descriptor node (scan context and ring key, feature context and ring
    key, validity) and every global candidate the detector hands to the
    closure are the JAX package's."""
    _, _, frames = scenario
    js, jm, ts, tm = context_pair
    for fid in range(N):
        assert jm.after_frame(fid, frames[fid]) is False
        assert tm.after_frame(fid, frames[fid]) is False
    jd, td = jm.detector, tm.detector
    nodes = sorted(td.contexts)
    assert nodes == sorted(jd.contexts) == list(range(N - 2))
    for store in ("contexts", "ringkeys", "contexts_feature",
                  "ringkeys_feature"):
        for i in nodes:
            np.testing.assert_array_equal(getattr(td, store)[i],
                                          getattr(jd, store)[i])
    assert td.valid_flags == jd.valid_flags
    assert len(jm.calls) >= 1
    assert [c[:2] for c in tm.calls] == [c[:2] for c in jm.calls]
    for (_, _, tT), (_, _, jT) in zip(tm.calls, jm.calls):
        np.testing.assert_allclose(tT, jT, atol=1e-12, rtol=0)
