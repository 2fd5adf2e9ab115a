"""The port's frame loop on the hash-table probes (`probe_mode` cells and
brick: tracking, training and localization against the whole map state,
without a local set) against the JAX package's, at a small size on the CPU.

* Three synthetic frames through `process_frame` under each probe in both
  packages, from the same initial decoder. Their random draws (ray
  samples, batches) come from different generators, so the comparison is
  statistical, with test_torch_slice.py's bounds for the join loop: frame
  1's pose within 10 cm / 0.5 deg of the other package's and of ground
  truth, map point counts within 5 % after frames 0 and 1. Frame 2, the
  first tracked against a map trained from a tracked pose, is held to the
  JAX package's own spread at this size: over ten keys its frame-2 error
  reached 11.7 cm and 3.9 deg under `cells` (the port's over ten seeds:
  14.1 cm, 3.8 deg), so both packages within 15 cm / 5 deg of ground
  truth. The brick system keeps its brick cache in step with the one its
  map's table rebuilds (the same records; packed positions rounded as the
  JAX package's insert and rehash round them).
* Localization under `cells`: the port's cells map, saved, loaded by both
  packages (no local set: every GN iteration probes the map's hash table
  without the travel window), two frames each: poses within the GN stop
  step (1 mm / 0.01 deg, as test_torch_localization.py), every frame valid,
  the map and the decoder untouched in both.
"""

import numpy as np
import pytest
import torch

import jax

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.slam.system import PinSLAMSystem as JSystem
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions)
from pin_slam_tpu_torch.models import neural_points as tnpm
from pin_slam_tpu_torch.slam.system import PinSLAMSystem as TSystem
from pin_slam_tpu_torch.utils.map_io import save_implicit_map

jax.config.update("jax_default_matmul_precision", "highest")
N_FRAMES = 3
MAX_DT, MAX_DA = 0.10, 0.5            # test_torch_slice.py's
LATE_DT, LATE_DA = 0.15, 5.0           # frame 2: the reference's spread
LOC_DT_M, LOC_DA_DEG = 1e-3, 0.01      # test_torch_localization.py's
ARRAYS = ("positions", "orientations", "geo_features", "ts_create",
          "ts_update", "certainty", "table")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_config(cls, mode, track_on=True):
    cfg = cls()
    cfg.track_on = track_on
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
    cfg.init_iter_ratio = 100
    cfg.bs_new_sample = 128
    cfg.reg_iter_n = 20
    cfg.map_capacity = 1 << 16
    cfg.buffer_size = 1 << 18
    cfg.frame_point_cap = 1 << 13
    cfg.source_point_cap = 1 << 11
    cfg.max_frames = 16
    cfg.probe_mode = mode
    cfg.finalize()
    cfg.pool_capacity = 200_000
    return cfg


@pytest.fixture(scope="module")
def seq():
    s = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(N_FRAMES + 1, radius=6.0, revolutions=0.03,
                                ease_in_frames=4),
        dirs=lidar_directions(512, 32), max_range=60.0)
    return s, [s.frame(i) for i in range(N_FRAMES + 1)]


def _err(a, b):
    dt = np.linalg.norm(a[:3, 3] - b[:3, 3])
    R = a[:3, :3].T @ b[:3, :3]
    da = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    return dt, da


@pytest.fixture(scope="module")
def runs(seq):
    s, frames = seq
    out = {}
    for mode in ("cells", "brick"):
        js = JSystem(small_config(JConfig, mode))
        ts = TSystem(small_config(TConfig, mode), device="cpu")
        ts.params["geo_mlp"] = convert.mlp_from_numpy(
            jax.tree.map(np.asarray, js.params["geo_mlp"]), device="cpu")
        res = {}
        for name, sys_ in (("jax", js), ("torch", ts)):
            sys_.set_gt_poses(s.poses)
            poses, counts, valid = [], [], []
            for i in range(N_FRAMES):
                poses.append(sys_.process_frame(i, frames[i]))
                counts.append(int(sys_.state.count))
                valid.append(i == 0 or bool(sys_.last_tracking.valid))
            res[name] = (poses, counts, valid)
        out[mode] = (js, ts, res)
    return s, out


@pytest.mark.parametrize("mode", ["cells", "brick"])
def test_frames_on_the_hash_probes(runs, mode):
    s, out = runs
    js, ts, res = out[mode]
    assert not js._use_join and not ts._use_join
    assert ts._cur_lset is None and ts._loc_lset is None
    (jposes, jcounts, jvalid), (tposes, tcounts, tvalid) = (res["jax"],
                                                            res["torch"])
    assert all(tvalid) and all(jvalid)
    for other in (jposes[1], s.poses[1]):
        dt, da = _err(tposes[1], other)
        assert dt < MAX_DT and da < MAX_DA, (mode, dt, da)
    dt, da = _err(jposes[1], s.poses[1])
    assert dt < MAX_DT and da < MAX_DA, ("jax", mode, dt, da)
    for name, poses in (("torch", tposes), ("jax", jposes)):
        dt, da = _err(poses[2], s.poses[2])
        assert dt < LATE_DT and da < LATE_DA, (name, mode, dt, da)
    for j, t in zip(jcounts[:2], tcounts[:2]):
        assert abs(t - j) <= 0.05 * j, (mode, jcounts, tcounts)
    # the brick system keeps its cache in step with its table
    assert tnpm.has_btable(ts.state) == (mode == "brick")
    if mode == "brick":
        rebuilt = tnpm.rebuild_probe_cache(ts.state.replace(
            btable=ts.state.btable.clone()), ts.config.voxel_size_m)
        # (the insert's cache also keeps the records of cells whose table
        # slot a colliding cell took over; the dump brick is never read).
        # The insert rounds the packed position as the JAX package's jitted
        # insert, the rebuild as its jitted rehash: one 1/256 step apart on
        # a few records, in both packages alike
        live = rebuilt.btable[:-1, :, 0] >= 0
        a, b = rebuilt.btable[:-1][live], ts.state.btable[:-1][live]
        assert torch.equal(a[:, :2], b[:, :2])
        step = (a[:, 2] - b[:, 2]).abs()
        moved = step != 0
        assert moved.float().mean() <= 1e-3
        assert bool(torch.isin(step[moved], torch.tensor(
            [1, 256, 65536], dtype=step.dtype)).all())


def test_loop_registration_on_the_map_state(runs, seq):
    """The loop closure registers a scan against the map state itself
    (no local set) under the hash-table probes: from a pose 19 cm and
    1 deg off, frame 1's scan comes back to within 5 cm / 0.2 deg of its
    tracked pose (the map has trained on frame 2 since)."""
    from pin_slam_tpu_torch.slam.loop import LoopPgoManager

    _, frames = seq
    _, out = runs
    ts = out["cells"][1]
    mgr = LoopPgoManager(ts.config, ts)
    yaw = np.radians(1.0)
    off = np.eye(4)
    off[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    off[:3, 3] = [0.15, -0.1, 0.05]
    valid, pose, _, _, _ = mgr._register(frames[1], ts.pgo_poses[1] @ off,
                                         1)
    assert valid
    dt, da = _err(pose, ts.pgo_poses[1])
    assert dt < 0.05 and da < 0.2, (dt, da)


@pytest.fixture(scope="module")
def localized(runs, seq, tmp_path_factory):
    s, out = runs
    _, frames = seq
    _, ts_map, _ = out["cells"]
    path = str(tmp_path_factory.mktemp("loc_cells") / "pin_map.npz")
    save_implicit_map(path, ts_map.state, ts_map.params, ts_map.config)
    js = JSystem(small_config(JConfig, "cells"))
    ts = TSystem(small_config(TConfig, "cells"), device="cpu")
    for sys_ in (js, ts):
        sys_.set_gt_poses(s.poses[1:])
        sys_.load_map(path)
    return js, ts, s.poses[1:], frames[1:]


def _arrays(state, params, to_np):
    out = {f: to_np(getattr(state, f)) for f in ARRAYS}
    out["count"] = int(state.count)
    out.update({f"{k}{i}": to_np(w) for k in ("w", "b")
                for i, w in enumerate(params["geo_mlp"][k])})
    return out


def test_localization_on_the_cell_probe(localized):
    js, ts, gt, frames = localized
    assert ts._loc_lset is None and js.localization_mode
    j0 = _arrays(js.state, js.params, lambda a: np.array(a))
    t0 = _arrays(ts.state, ts.params, lambda a: a.numpy().copy())
    for fid in range(2):
        jp = js.process_frame(fid, frames[fid])
        tp = ts.process_frame(fid, frames[fid])
        if fid:
            assert bool(js.last_tracking.valid) and \
                bool(ts.last_tracking.valid)
        dt, da = _err(jp, tp)
        assert dt <= LOC_DT_M and da <= LOC_DA_DEG, (fid, dt, da)
        assert np.linalg.norm(tp[:3, 3] - gt[fid][:3, 3]) < 0.15, fid
    assert not ts.last_did_map
    for before, after in (
            (j0, _arrays(js.state, js.params, lambda a: np.array(a))),
            (t0, _arrays(ts.state, ts.params, lambda a: a.numpy()))):
        for k in before:
            np.testing.assert_array_equal(before[k], after[k], err_msg=k)
