"""The port's semantic mapping against the JAX package, at a small size on
the CPU (256 x 16 rays, map 2^14, as tests/test_rgbd_semantic.py), on
`default_scene_semantic`'s room and labels. The JAX system maps frame 0;
its map, replay pool (with the semantic labels), decoders and host state
are carried into the port with pin_slam_tpu_torch.convert.

* the port's copies of `default_scene_semantic` and `sem_kitti_color`
  (equal);
* the semantic decoder head and the NLL loss (1e-6);
* `query_decode`'s semantic head on the training's cached-candidate route
  and on the cell-probe route, under both `weighted_first` values:
  log-probabilities (1e-5) and their gradients w.r.t. the geometry
  features and the semantic decoder (1e-5, relative to the largest);
* `Mesher.vertex_attributes` (labels equal);
* frames 1 and 2 through both systems' `process_frame(sem_labels=...)`
  from the carried state: frame 1 registers on the same map (pose to the GN
  stop step, 1 mm / 0.01 deg); the frame-1 samples and training draws
  differ between the packages, so frame 2 is held to the other system
  within 5 cm and to ground truth within 20 cm (see MAX_DT), and the
  decoded labels at the frame's points to the ground truth (accuracy
  >= 0.8, tests/test_rgbd_semantic.py's bound) and to each other.

torch runs on one thread: the summation order decides the GN stop step.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.dataset.synthetic import (
    default_scene_semantic as j_scene_semantic)
from pin_slam_tpu.models import decoder as jdec
from pin_slam_tpu.models import losses as jlo
from pin_slam_tpu.ops import knn_join as jk
from pin_slam_tpu.slam import map_query as jmq
from pin_slam_tpu.slam.mesher import MeshConfig as JMeshConfig
from pin_slam_tpu.slam.mesher import Mesher as JMesher
from pin_slam_tpu.slam.system import PinSLAMSystem as JSystem
from pin_slam_tpu.utils.semantic_kitti_utils import (
    sem_kitti_color as j_sem_kitti_color)
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene_semantic,
    lidar_directions)
from pin_slam_tpu_torch.models import decoder as tdec
from pin_slam_tpu_torch.models import losses as tlo
from pin_slam_tpu_torch.models import neural_points as tnpm
from pin_slam_tpu_torch.slam import map_query as tmq
from pin_slam_tpu_torch.slam.mesher import MeshConfig as TMeshConfig
from pin_slam_tpu_torch.slam.mesher import Mesher as TMesher
from pin_slam_tpu_torch.slam.system import PinSLAMSystem as TSystem
from pin_slam_tpu_torch.utils.semantic_kitti_utils import sem_kitti_color

jax.config.update("jax_default_matmul_precision", "highest")
N_CLASS = 4
HOST = ("pgo_poses", "odom_poses", "travel_dist", "cur_pose_ref",
        "last_pose_ref", "last_odom_tran", "lose_track", "stop_status",
        "stop_count", "consecutive_lose_track_frame", "reboot_ts",
        "decoder_freezed", "cur_frame", "gt_poses")
GN_STOP_M, GN_STOP_DEG = 1e-3, 0.01
# frame 2 after the packages' own sample and batch draws: the two systems
# within 5 cm of each other (measured 0.1-1.8 cm over torch seeds), each
# within 20 cm of ground truth (at this size the JAX package's own frame 2
# is 15 cm off; a lost track is off by the 9.4 cm a frame and more)
MAX_DT, MAX_GT_DT = 0.05, 0.20


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


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-12))


def test_semantic_scene_and_colors_are_copies():
    rng = np.random.RandomState(0)
    p = rng.uniform(-20, 20, (2000, 3)) * [1, 0.7, 0.2]
    (js_, jl), (ts_, tl) = j_scene_semantic(), default_scene_semantic()
    np.testing.assert_array_equal(ts_(p), js_(p))
    np.testing.assert_array_equal(tl(p), jl(p))
    labels = rng.randint(0, 20, 300)
    np.testing.assert_array_equal(sem_kitti_color(labels),
                                  j_sem_kitti_color(labels))


def test_semantic_head_and_nll_loss():
    rng = np.random.RandomState(1)
    x = rng.randn(300, 11).astype(np.float32)
    mlp = jdec.init_mlp_params(jax.random.PRNGKey(2), 11, 64, 1, 20)
    tm = convert.mlp_from_numpy(_np_mlp(mlp), device="cpu")
    jlp = jdec.sem_log_prob_apply(mlp, jnp.asarray(x))
    tlp = tdec.sem_log_prob_apply(tm, _t(x))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-6,
                               rtol=0)
    label = rng.randint(-1, 22, 300)            # clipped to the classes
    mask = rng.rand(300) < 0.7
    j = jlo.sem_nll_loss(jlp, jnp.asarray(label), jnp.asarray(mask))
    t = tlo.sem_nll_loss(tlp, _t(label), _t(mask))
    assert abs(float(t) - float(j)) <= 1e-6


def small_config(cls):
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
    cfg.reg_iter_n = 50
    cfg.map_capacity = 1 << 14
    cfg.buffer_size = 1 << 16
    cfg.frame_point_cap = 1 << 12
    cfg.source_point_cap = 1 << 10
    cfg.max_frames = 16
    cfg.local_set_cap = 1 << 14
    cfg.train_subset_hist = 2048
    cfg.probe_mode = "join"
    cfg.semantic_on = True
    cfg.sem_class_count = N_CLASS
    cfg.finalize()
    cfg.pool_capacity = 100_000
    return cfg


def _labels(label_fn, pts, pose):
    w = pts[:, :3] @ pose[:3, :3].T + pose[:3, 3]
    return label_fn(w.astype(np.float64))


@pytest.fixture(scope="module")
def mapped():
    scene, label_fn = default_scene_semantic()
    seq = SyntheticSequence(
        scene_sdf=scene,
        poses=circle_trajectory(3, radius=6.0, revolutions=0.005,
                                ease_in_frames=0),
        dirs=lidar_directions(256, 16), max_range=60.0)
    frames = [seq.frame(i) for i in range(3)]
    labels = [_labels(label_fn, f, p) for f, p in zip(frames, seq.poses)]
    js = JSystem(small_config(JConfig))
    js.set_gt_poses(seq.poses)
    js.process_frame(0, frames[0], sem_labels=labels[0])
    snap = dict(
        state={f: np.asarray(getattr(js.state, f))
               for f in convert.STATE_FIELDS},
        pool={f: np.asarray(getattr(js.pool, f))
              for f in convert.POOL_FIELDS + ("sem_label",)},
        params={k: _np_mlp(js.params[k]) for k in ("geo_mlp", "sem_mlp")},
        host={k: copy.deepcopy(getattr(js, k)) for k in HOST},
        lset=js._cur_lset._asdict(),
        track_feats=np.asarray(js._cur_track_feats))
    return js, seq, frames, labels, label_fn, snap


def _cfg(weighted_first, cls):
    c = small_config(cls)
    c.weighted_first = weighted_first
    return c


@pytest.mark.parametrize("route", ["cand", "cells"])
@pytest.mark.parametrize("weighted_first", [True, False])
def test_query_decode_semantic_head(mapped, route, weighted_first):
    """On the trained frame-0 map and decoders, at the frame-1 points."""
    js, seq, frames, _, _, snap = mapped
    jqp = jmq.make_query_params(_cfg(weighted_first, JConfig))
    tqp = tmq.make_query_params(_cfg(weighted_first, TConfig))
    tparams, ts = convert.from_jax(snap["params"], snap["state"],
                                   device="cpu")
    rng = np.random.RandomState(3)
    q = frames[1][rng.randint(0, len(frames[1]), 500), :3]
    q = (q @ seq.poses[1][:3, :3].T + seq.poses[1][:3, 3]
         + rng.randn(500, 3) * 0.1).astype(np.float32)
    jmlp, smlp = js.params["geo_mlp"], js.params["sem_mlp"]
    if route == "cells":
        jf = js.params["geo_features"]
        jkw, tkw, jstate = dict(), dict(state=ts), js.state
    else:
        m = jnp.arange(js.state.capacity) < js.state.count
        jls = jk.build_local_set(js.state.positions, m, jqp.resolution,
                                 1 << 14, certainty=js.state.certainty)
        tls = convert.lset_from_numpy(jls._asdict(), device="cpu")
        jf = js.params["geo_features"][jls.gidx]
        # the candidates from the port's k-NN (bit-equal to the JAX
        # package's, tests/test_torch_knn_join.py), fed to both sides
        qn = tnpm.query_neighbors_join(
            _t(q), tls, nn_k=tqp.nn_k + 2, max_dist2=tqp.join_max_dist2,
            resolution=tqp.resolution)
        idx, valid = qn.idx.numpy(), qn.valid.numpy()
        jkw = dict(lset=jls, cand=(jnp.asarray(idx, jnp.int32),
                                   jnp.asarray(valid)))
        tkw = dict(lset=tls, cand=(_t(idx).long(), _t(valid)))
        jstate = None

    def jfun(f, sm):
        kw = dict(jkw)
        if route == "cand":
            kw["cand_pack"] = (jmq.pack_lset_nodiff(jls), f)
        o = jmq.query_decode(jstate, f, jmlp, jnp.asarray(q), jqp,
                             sem_mlp=sm, **kw)
        return jnp.sum(o.sem_log_prob * np.linspace(-1, 1, N_CLASS)), o

    (jgf, jgs), jo = jax.grad(jfun, argnums=(0, 1), has_aux=True)(jf, smlp)
    tf = _t(jf).requires_grad_(True)
    tsm = convert.mlp_from_numpy(_np_mlp(smlp), device="cpu")
    for t in tsm["w"] + tsm["b"]:
        t.requires_grad_(True)
    if route == "cand":
        tkw["cand_pack"] = (tmq.pack_lset_nodiff(tls), tf)
    to = tmq.query_decode(tf, tparams["geo_mlp"], _t(q), tqp, sem_mlp=tsm,
                          **tkw)
    (to.sem_log_prob * torch.linspace(-1, 1, N_CLASS)).sum().backward()
    np.testing.assert_allclose(to.sem_log_prob.detach().numpy(),
                               np.asarray(jo.sem_log_prob), atol=1e-5,
                               rtol=0)
    assert _rel(tf.grad.numpy(), jgf) < 1e-5
    for tg, jg in zip(tsm["w"] + tsm["b"], jgs["w"] + jgs["b"]):
        assert _rel(tg.grad.numpy(), jg) < 1e-5


def test_vertex_attributes_semantic(mapped):
    js, seq, frames, labels, _, snap = mapped
    tparams, ts = convert.from_jax(snap["params"], snap["state"],
                                   device="cpu")
    v = (frames[0][::3, :3] @ seq.poses[0][:3, :3].T
         + seq.poses[0][:3, 3]).astype(np.float32)
    jm = JMesher(js.qp, JMeshConfig(infer_bs=512), semantic_on=True)
    tm = TMesher(ts_qp := tmq.make_query_params(small_config(TConfig)),
                 TMeshConfig(infer_bs=512), semantic_on=True)
    assert ts_qp.weighted_first
    jc, jl = jm.vertex_attributes(js.state, js.params["geo_features"],
                                  js.params["geo_mlp"], v,
                                  sem_mlp=js.params["sem_mlp"])
    tc, tl = tm.vertex_attributes(ts, tparams["geo_features"],
                                  tparams["geo_mlp"], v,
                                  sem_mlp=tparams["sem_mlp"])
    assert jc is None and tc is None
    np.testing.assert_array_equal(tl, jl)
    assert (tl == labels[0][::3]).mean() > 0.8


def _close_to_gn_step(Ta, Tb):
    assert np.linalg.norm(Ta[:3, 3] - Tb[:3, 3]) <= GN_STOP_M
    R = Ta[:3, :3].T @ Tb[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    assert np.degrees(np.arcsin(min(np.linalg.norm(w) / 2, 1.0))) \
        <= GN_STOP_DEG


def test_semantic_system_frames(mapped):
    """Runs last: it moves the JAX system on from frame 0."""
    js, seq, frames, labels, label_fn, snap = mapped
    ts = TSystem(small_config(TConfig), device="cpu")
    ts.state = convert.state_from_numpy(snap["state"], device="cpu")
    ts.pool = convert.pool_from_numpy(snap["pool"], device="cpu")
    ts.params = {k: convert.mlp_from_numpy(v, device="cpu")
                 for k, v in snap["params"].items()}
    ts.sync_feature_params()
    for k, v in snap["host"].items():
        setattr(ts, k, copy.deepcopy(v))
    # the tracker registers against the post-train local set
    ts._cur_lset = convert.lset_from_numpy(snap["lset"], device="cpu")
    ts._cur_track_feats = _t(snap["track_feats"])

    poses = []
    for i in (1, 2):
        pj = js.process_frame(i, frames[i], sem_labels=labels[i])
        pt = ts.process_frame(i, frames[i], sem_labels=labels[i])
        poses.append((pj, pt))
        assert bool(ts.last_tracking.valid) and bool(js.last_tracking.valid)
    _close_to_gn_step(*poses[0])
    pj, pt = poses[1]
    gt = seq.poses[2][:3, 3]
    assert np.linalg.norm(pt[:3, 3] - gt) < MAX_GT_DT
    assert np.linalg.norm(pj[:3, 3] - gt) < MAX_GT_DT
    assert np.linalg.norm(pt[:3, 3] - pj[:3, 3]) < MAX_DT
    # the pool holds the frames' labels on the surface samples
    n = int(ts.pool.count)
    assert set(np.unique(ts.pool.sem_label[:n].numpy())) <= {0, 1, 2, 3}

    w = (frames[2][::3, :3] @ seq.poses[2][:3, :3].T
         + seq.poses[2][:3, 3]).astype(np.float32)
    gt_lab = label_fn(w.astype(np.float64))
    jo = jmq.query_decode(js.state, js.params["geo_features"],
                          js.params["geo_mlp"], jnp.asarray(w), js.qp,
                          sem_mlp=js.params["sem_mlp"])
    with torch.no_grad():
        to = tmq.query_decode(ts.params["geo_features"],
                              ts.params["geo_mlp"], _t(w), ts.qp,
                              state=ts.state, sem_mlp=ts.params["sem_mlp"])
    preds = []
    for nn, lp in ((np.asarray(jo.nn_count), np.asarray(jo.sem_log_prob)),
                   (to.nn_count.numpy(), to.sem_log_prob.numpy())):
        v = nn >= 6              # 77 % of the points at this size
        assert v.mean() > 0.6
        pred = lp.argmax(-1)
        assert (pred[v] == gt_lab[v]).mean() >= 0.8
        preds.append(pred)
    assert (preds[0] == preds[1]).mean() > 0.9
