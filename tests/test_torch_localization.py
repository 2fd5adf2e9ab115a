"""The port's localization mode (PinSLAMSystem.load_map + process_frame)
against the JAX package's, on one saved map on the CPU.

The map: four frames of a 256 x 16-ray scan mapped by the port on their
true poses, saved with `utils/map_io.save_implicit_map`. Both packages load
that one file (the JAX package in join mode, its k-NN in Pallas interpret
mode):
* the frozen join set, built once over the whole map, is bit-equal (points,
  global indices, certainty, count) and so are the compact features and the
  rehashed table;
* three frames localized by each package (the true first pose, then
  tracking from the motion model) give poses within the GN stop step
  (1 mm / 0.01 deg, as tests/test_torch_loop.py: where a float32 sum rounds
  the other way, one run takes one more step), every frame valid;
* the map and the decoder are untouched in both: every array bit-equal
  before and after, the count the same, no training, no insert.
"""

import numpy as np
import pytest
import torch

import jax

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.slam.system import PinSLAMSystem as JSystem
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions)
from pin_slam_tpu_torch.slam.system import PinSLAMSystem as TSystem
from pin_slam_tpu_torch.utils.map_io import save_implicit_map

jax.config.update("jax_default_matmul_precision", "highest")
N_MAP, N_LOC, OFFSET = 4, 3, 1
MAX_DT_M, MAX_DA_DEG = 1e-3, 0.01
ARRAYS = ("positions", "orientations", "geo_features", "ts_create",
          "ts_update", "certainty", "table")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_config(cls, track_on):
    cfg = cls()
    cfg.track_on = track_on
    cfg.max_range = 60.0
    cfg.min_range = 0.5
    cfg.vox_down_m = 0.08
    cfg.voxel_size_m = 0.3
    cfg.sigma_sigmoid_m = 0.1
    cfg.loss_weight_on = True
    cfg.surface_sample_range_m = 0.25
    cfg.bs = 1024
    cfg.iters = 12
    cfg.init_iter_ratio = 10
    cfg.bs_new_sample = 512
    cfg.source_vox_down_m = 0.4
    cfg.reg_iter_n = 30
    cfg.map_capacity = 1 << 15
    cfg.buffer_size = 1 << 18
    cfg.frame_point_cap = 1 << 13
    cfg.source_point_cap = 1 << 11
    cfg.max_frames = 16
    cfg.local_set_cap = 1 << 15
    cfg.train_subset_hist = 8192
    cfg.probe_mode = "join"
    cfg.finalize()
    cfg.pool_capacity = 200_000
    return cfg


@pytest.fixture(scope="module")
def saved_map(tmp_path_factory):
    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(N_MAP + OFFSET + N_LOC, radius=6.0,
                                revolutions=0.06, ease_in_frames=2),
        dirs=lidar_directions(256, 16), max_range=60.0)
    frames = [seq.frame(i) for i in range(len(seq))]
    ts = TSystem(small_config(TConfig, track_on=False), device="cpu")
    ts.set_gt_poses(seq.poses)
    for fid in range(N_MAP):
        ts.process_frame(fid, frames[fid])
    path = str(tmp_path_factory.mktemp("loc") / "pin_map.npz")
    save_implicit_map(path, ts.state, ts.params, ts.config)
    return path, seq.poses[OFFSET:OFFSET + N_LOC], \
        frames[OFFSET:OFFSET + N_LOC]


@pytest.fixture(scope="module")
def loaded(saved_map):
    path, gt, _ = saved_map
    js = JSystem(small_config(JConfig, track_on=True))
    js.set_gt_poses(gt)
    js.load_map(path)
    ts = TSystem(small_config(TConfig, track_on=True), device="cpu")
    ts.set_gt_poses(gt)
    ts.load_map(path)
    return js, ts


def _port_arrays(ts):
    s = ts.state
    out = {f: getattr(s, f).numpy().copy() for f in ARRAYS}
    out["count"] = int(s.count)
    out.update({f"{k}{i}": w.numpy().copy()
                for k in ("w", "b")
                for i, w in enumerate(ts.params["geo_mlp"][k])})
    return out


def _jax_arrays(js):
    s = js.state
    out = {f: np.array(getattr(s, f)) for f in ARRAYS}
    out["count"] = int(s.count)
    out.update({f"{k}{i}": np.array(w)
                for k in ("w", "b")
                for i, w in enumerate(js.params["geo_mlp"][k])})
    return out


def test_frozen_join_set_is_bit_equal(loaded):
    js, ts = loaded
    assert js.localization_mode and ts.localization_mode
    assert js.decoder_freezed and ts.decoder_freezed
    assert js._map_deformed is False and ts._map_deformed is False
    jl, tl = js._loc_lset, ts._loc_lset
    cnt = int(ts.state.count)
    assert tl.cap == jl.cap == -(-cnt // 512) * 512
    assert int(tl.count) == int(jl.count) == cnt
    np.testing.assert_array_equal(tl.pts.numpy(), np.asarray(jl.pts))
    np.testing.assert_array_equal(tl.gidx.numpy(), np.asarray(jl.gidx))
    np.testing.assert_array_equal(tl.cert.numpy(), np.asarray(jl.cert))
    assert tl.quat is None and jl.quat is None
    np.testing.assert_array_equal(ts._loc_feats.numpy(),
                                  np.asarray(js._loc_feats))
    np.testing.assert_array_equal(ts.state.table.numpy(),
                                  np.asarray(js.state.table))


def test_localized_poses_agree_and_the_map_is_untouched(loaded, saved_map):
    js, ts = loaded
    _, gt, frames = saved_map
    j0, t0 = _jax_arrays(js), _port_arrays(ts)
    trains = []
    ts.train = lambda *a, **k: trains.append(a)
    for fid in range(N_LOC):
        jp = js.process_frame(fid, frames[fid])
        tp = ts.process_frame(fid, frames[fid])
        if fid:
            assert bool(js.last_tracking.valid) and \
                bool(ts.last_tracking.valid), fid
        dR = jp[:3, :3].T @ tp[:3, :3]
        da = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        dt = np.linalg.norm(jp[:3, 3] - tp[:3, 3])
        assert dt <= MAX_DT_M and da <= MAX_DA_DEG, (fid, dt, da)
        # tracking against the frozen map lands near the truth (the frames
        # move 0.35 m; a 4-frame map at this scan density holds 3-7 cm)
        assert np.linalg.norm(tp[:3, 3] - gt[fid][:3, 3]) < 0.15, fid
    assert not trains and not ts.last_did_map
    for before, after in ((j0, _jax_arrays(js)), (t0, _port_arrays(ts))):
        assert sorted(before) == sorted(after)
        for k in before:
            np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    for k in t0:
        if k not in ("table", "count"):
            np.testing.assert_array_equal(t0[k][: t0["count"]],
                                          j0[k][: j0["count"]], err_msg=k)
    assert t0["count"] == j0["count"]


def test_color_localization_tracks_the_sets_own_rows(tmp_path):
    """A stated departure from the reference (ROADMAP.md, settled): in
    localization mode the port's colour tracker reads the colour features
    of the frozen join set's own rows (`_loc_cfeats`, the whole map's
    colour features gathered at the set's global rows), as it reads the
    geometric ones. The JAX package hands the tracker the whole map's
    `params["color_features"]` with the set's local row indices
    (pin_slam_tpu/slam/system.py:872-899), so it reads map row i for local
    row i: the two agree only where a local row is the map row of the same
    index. Both load one saved colour map and build the same set."""
    from pin_slam_tpu_torch.dataset.synthetic import procedural_color

    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(2, radius=6.0, revolutions=0.02,
                                ease_in_frames=1),
        dirs=lidar_directions(256, 16), max_range=60.0,
        color_fn=procedural_color)
    cfgs = []
    for cls, track_on in ((TConfig, False), (TConfig, True),
                          (JConfig, True)):
        c = small_config(cls, track_on=track_on)
        c.color_on, c.color_channel, c.iters = True, 3, 4
        cfgs.append(c)
    ts = TSystem(cfgs[0], device="cpu")
    ts.set_gt_poses(seq.poses)
    for fid in range(2):
        ts.process_frame(fid, seq.frame(fid))
    path = str(tmp_path / "pin_map.npz")
    save_implicit_map(path, ts.state, ts.params, ts.config)

    tl = TSystem(cfgs[1], device="cpu")
    tl.load_map(path)
    jl = JSystem(cfgs[2])
    jl.load_map(path)
    gidx = tl._loc_lset.gidx.numpy()
    np.testing.assert_array_equal(gidx, np.asarray(jl._loc_lset.gidx))
    live = int(tl._loc_lset.count)
    whole = np.asarray(jl.params["color_features"])
    np.testing.assert_array_equal(tl.state.color_features.numpy(), whole)
    port = tl._loc_cfeats.numpy()
    # the port: the map's colour features at the set's rows, as the
    # geometric features both packages gather
    np.testing.assert_array_equal(port, whole[gidx])
    np.testing.assert_array_equal(tl._loc_feats.numpy(),
                                  np.asarray(jl._loc_feats))
    # the reference: map row i for local row i
    ref = whole[: port.shape[0]]
    same_row = gidx[:live] == np.arange(live)
    assert live > 1000 and (~same_row).sum() > live // 2
    moved = ~same_row & (np.abs(whole[gidx[:live]] - ref[:live]).max(1) > 0)
    assert moved.any()
    assert not np.array_equal(port[:live], ref[:live])
    np.testing.assert_array_equal(port[:live][same_row], ref[:live][same_row])
