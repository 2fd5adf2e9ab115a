"""The port's colour tracking and a colour system run against the JAX
package, at a small size on the CPU (256 x 16 rays, map 2^14, as
tests/test_rgbd_semantic.py). The JAX system maps frame 0 of a coloured
synthetic sequence; its map (with the colour features), replay pool (with
the colour labels), decoders and host state are carried into the port with
pin_slam_tpu_torch.convert.

* The colour tracker's uncached path (one k-NN probe and a decode of the
  SDF and colour heads every GN iteration) in `color_mode` 1 (the
  consistency weight exp(-|I_pred - I_src|)) and 2 (the photometric term)
  on the same local set, features and decoders: poses to the GN stop step
  (1 mm / 0.01 deg, as tests/test_torch_loop.py allows: the stop step
  decides one more iteration), equal validity.
* Frames 1 and 2 through both systems' `process_frame` from the carried
  state: frame 1 registers on the same map (pose to the GN stop step); the
  frame-1 samples and training draws differ between the packages, so frame
  2 is held to ground truth and to the other system within 10 cm (the
  bound of tests/test_torch_slice.py), and the decoded colour at the frame's
  points to the procedural ground truth and to the other system.

torch runs on one thread: the summation order decides the GN stop step.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.slam import map_query as jmq
from pin_slam_tpu.slam.system import PinSLAMSystem as JSystem
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions,
    procedural_color)
from pin_slam_tpu_torch.slam import map_query as tmq
from pin_slam_tpu_torch.slam.system import PinSLAMSystem as TSystem

HOST = ("pgo_poses", "odom_poses", "travel_dist", "cur_pose_ref",
        "last_pose_ref", "last_odom_tran", "lose_track", "stop_status",
        "stop_count", "consecutive_lose_track_frame", "reboot_ts",
        "decoder_freezed", "cur_frame", "gt_poses")
GN_STOP_M, GN_STOP_DEG = 1e-3, 0.01
MAX_DT = 0.10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_mlp(mlp):
    return jax.tree.map(np.asarray, mlp)


def small_config(cls, photometric=False):
    cfg = cls()
    cfg.track_on = True
    cfg.max_range = 60.0
    cfg.min_range = 0.5
    cfg.vox_down_m = 0.08
    cfg.source_vox_down_m = 0.4
    cfg.voxel_size_m = 0.3
    cfg.sigma_sigmoid_m = 0.1
    cfg.surface_sample_range_m = 0.25
    cfg.loss_weight_on = True
    cfg.bs = 1024
    cfg.iters = 3
    cfg.init_iter_ratio = 60
    cfg.bs_new_sample = 256
    cfg.reg_iter_n = 20
    cfg.map_capacity = 1 << 14
    cfg.buffer_size = 1 << 16
    cfg.frame_point_cap = 1 << 12
    cfg.source_point_cap = 1 << 10
    cfg.max_frames = 16
    cfg.local_set_cap = 1 << 14
    cfg.train_subset_hist = 2048
    cfg.probe_mode = "join"
    cfg.color_on = True
    cfg.color_channel = 3
    cfg.photometric_loss_on = photometric
    cfg.finalize()
    cfg.pool_capacity = 100_000
    return cfg


@pytest.fixture(scope="module")
def mapped():
    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(3, radius=6.0, revolutions=0.02,
                                ease_in_frames=2),
        dirs=lidar_directions(256, 16), max_range=60.0,
        color_fn=procedural_color)
    frames = [seq.frame(i) for i in range(3)]
    js = JSystem(small_config(JConfig))
    js.set_gt_poses(seq.poses)
    js.process_frame(0, frames[0])
    snap = dict(
        state={f: np.asarray(getattr(js.state, f))
               for f in convert.STATE_FIELDS + convert.COLOR_FIELDS},
        pool={f: np.asarray(getattr(js.pool, f))
              for f in convert.POOL_FIELDS + convert.POOL_LABEL_FIELDS
              if getattr(js.pool, f) is not None},
        params={k: _np_mlp(js.params[k]) for k in ("geo_mlp", "color_mlp")},
        host={k: copy.deepcopy(getattr(js, k)) for k in HOST})
    return js, seq, frames, snap


def _rot_deg(Ra, Rb):
    R = Ra.T @ Rb
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return np.degrees(np.arcsin(min(np.linalg.norm(w) / 2, 1.0)))


def _close_to_gn_step(Ta, Tb):
    assert np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]) <= GN_STOP_M
    assert _rot_deg(Ta[:3, :3], Tb[:3, :3]) <= GN_STOP_DEG


@pytest.mark.parametrize("photometric", [False, True])
def test_color_tracker_parity(mapped, photometric):
    """color_mode 1 (photometric off: the consistency weight) and 2, from
    an initial guess 7 cm off."""
    js, seq, frames, _ = mapped
    c = js.config
    jtrack = (JSystem(small_config(JConfig, True))._track if photometric
              else js._track)
    pre = js._run_preprocess(frames[1], None)
    src_pts, src_attr, src_n = pre[3], pre[4], pre[5]
    anchor = seq.poses[0][:3, 3].copy()
    T_init = seq.poses[1].copy()
    T_init[:3, 3] += np.array([0.06, -0.04, 0.02]) - anchor
    # the arguments as process_frame passes them (one compiled tracker)
    lf = js._lf(0, sensor_pos=np.zeros(3))
    jls, jf, jcf = js._build_lset_track(
        js.state, js.params["geo_features"], lf.travel_dist, jnp.int32(0),
        jnp.asarray(seq.poses[0][:3, 3], jnp.float32), jnp.int32(0))
    cols = src_attr[:, :3]
    inten = 0.299 * cols[:, 0] + 0.587 * cols[:, 1] + 0.114 * cols[:, 2]
    mask = jnp.arange(c.source_point_cap) < src_n
    jres = jtrack(js.state, jf, js.params["geo_mlp"], src_pts, mask,
                  jnp.asarray(T_init, jnp.float32), lf,
                  jnp.asarray(anchor, jnp.float32), lset=jls,
                  src_intensity=inten, color_features=jcf,
                  color_mlp=js.params["color_mlp"])

    ts = TSystem(small_config(TConfig, photometric), device="cpu")
    assert ts._use_color_track
    tres = ts._track(
        _t(jf), convert.mlp_from_numpy(_np_mlp(js.params["geo_mlp"]),
                                       device="cpu"),
        _t(src_pts), _t(mask), torch.as_tensor(T_init, dtype=torch.float32),
        torch.as_tensor(anchor, dtype=torch.float32),
        convert.lset_from_numpy(jls._asdict(), device="cpu"),
        src_intensity=_t(inten), color_features=_t(jcf),
        color_mlp=convert.mlp_from_numpy(_np_mlp(js.params["color_mlp"]),
                                         device="cpu"))
    assert bool(tres.valid) == bool(jres.valid)
    _close_to_gn_step(tres.pose.numpy().astype(np.float64),
                      np.asarray(jres.pose, np.float64))
    gt = seq.poses[1][:3, 3] - anchor
    assert np.linalg.norm(tres.pose.numpy()[:3, 3] - gt) < 0.05


def test_color_system_frames(mapped):
    """Runs last: it moves the JAX system on from frame 0."""
    js, seq, frames, snap = mapped
    ts = TSystem(small_config(TConfig), device="cpu")
    ts.state = convert.state_from_numpy(snap["state"], device="cpu")
    ts.pool = convert.pool_from_numpy(snap["pool"], device="cpu")
    ts.params = {k: convert.mlp_from_numpy(v, device="cpu")
                 for k, v in snap["params"].items()}
    ts.sync_feature_params()
    for k, v in snap["host"].items():
        setattr(ts, k, copy.deepcopy(v))

    poses = []
    for i in (1, 2):
        pj = js.process_frame(i, frames[i])
        pt = ts.process_frame(i, frames[i])
        poses.append((pj, pt))
        assert bool(ts.last_tracking.valid) and bool(js.last_tracking.valid)
    _close_to_gn_step(*poses[0])
    pj, pt = poses[1]
    gt = seq.poses[2][:3, 3]
    assert np.linalg.norm(pt[:3, 3] - gt) < MAX_DT
    assert np.linalg.norm(pj[:3, 3] - gt) < MAX_DT
    assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < MAX_DT
    assert int(ts.state.count) == pytest.approx(int(js.state.count),
                                                rel=0.05)

    pts = frames[2][::4]
    w = (pts[:, :3] @ seq.poses[2][:3, :3].T + seq.poses[2][:3, 3]).astype(
        np.float32)
    jo = jmq.query_decode(js.state, js.params["geo_features"],
                          js.params["geo_mlp"], jnp.asarray(w), js.qp,
                          color_features=js.params["color_features"],
                          color_mlp=js.params["color_mlp"], color_channel=3)
    with torch.no_grad():
        to = tmq.query_decode(ts.params["geo_features"],
                              ts.params["geo_mlp"], _t(w), ts.qp,
                              state=ts.state,
                              color_features=ts.params["color_features"],
                              color_mlp=ts.params["color_mlp"],
                              color_channel=3)
    maes = []
    for nn, col in ((np.asarray(jo.nn_count), np.asarray(jo.color)),
                    (to.nn_count.numpy(), to.color.numpy())):
        v = nn >= 6
        assert v.mean() > 0.8
        maes.append(float(np.abs(col[v] - pts[v, 3:6]).mean()))
    # three frames of training: both decoders have learnt the colour to a
    # mean error of ~0.1 (the JAX package's own 5-frame test asks 0.08)
    assert max(maes) < 0.2, maes
    assert abs(maes[0] - maes[1]) < 0.03, maes
