"""The port's tracker against the JAX package's: the JAX system maps one
synthetic frame, its map, local set, trained features and decoder are
carried across with pin_slam_tpu_torch.convert, and both trackers register
the next frame's source cloud from the same initial guess. Poses agree to
<= 1e-4 m and <= 1e-3 deg; iteration count, validity and failure code are
equal. Both decode modes: with `weighted_first=False` the tracker decodes at
every neighbour and drops points whose neighbours disagree (sdf_std)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.slam.system import PinSLAMSystem as JSystem
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions)
from pin_slam_tpu_torch.ops.transforms import np_rotation_angle_deg
from pin_slam_tpu_torch.slam import map_query as tmq
from pin_slam_tpu_torch.slam.system import PinSLAMSystem as TSystem


def small_config(cls, weighted_first=True):
    cfg = cls()
    cfg.weighted_first = weighted_first
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
    cfg.init_iter_ratio = 100
    cfg.bs_new_sample = 256
    cfg.reg_iter_n = 20
    cfg.map_capacity = 1 << 16
    cfg.buffer_size = 1 << 18
    cfg.frame_point_cap = 1 << 13
    cfg.source_point_cap = 1 << 11
    cfg.max_frames = 16
    cfg.local_set_cap = 1 << 13
    cfg.train_subset_hist = 2048
    cfg.probe_mode = "join"
    cfg.finalize()
    cfg.pool_capacity = 200_000
    return cfg


def _mapped(weighted_first):
    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(4, radius=6.0, revolutions=0.03),
        dirs=lidar_directions(512, 32), max_range=60.0)
    js = JSystem(small_config(JConfig, weighted_first))
    js.set_gt_poses(seq.poses)
    js.process_frame(0, seq.frame(0))
    return js, seq


@pytest.fixture(scope="module")
def mapped():
    return _mapped(True)


@pytest.fixture(scope="module")
def mapped_per_neighbour():
    return _mapped(False)


OFFSETS = [(0.0, 0.0, 0.0, 0.0), (0.12, -0.08, 0.03, 1.5)]


@pytest.mark.parametrize("offset", OFFSETS)
def test_tracker_pose_parity(mapped, offset):
    _pose_parity(*mapped, offset, True)


@pytest.mark.parametrize("offset", OFFSETS)
def test_tracker_pose_parity_per_neighbour_decode(mapped_per_neighbour,
                                                  offset):
    _pose_parity(*mapped_per_neighbour, offset, False)


def _pose_parity(js, seq, offset, weighted_first):
    assert js.qp.weighted_first is weighted_first
    pre = js._run_preprocess(seq.frame(1), None)
    src_pts, src_n = np.array(pre[3]), int(pre[5])
    anchor = seq.poses[0][:3, 3].copy()
    T_init = seq.poses[1].copy()
    yaw = np.radians(offset[3])
    Rz = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                   [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]])
    T_init[:3, :3] = Rz @ T_init[:3, :3]
    T_init[:3, 3] += np.asarray(offset[:3]) - anchor
    mask = np.arange(src_pts.shape[0]) < src_n

    jres = js._track(js.state, js._cur_track_feats, js.params["geo_mlp"],
                     jnp.asarray(src_pts), jnp.asarray(mask),
                     jnp.asarray(T_init, jnp.float32), None,
                     jnp.asarray(anchor, jnp.float32), lset=js._cur_lset)

    ts = TSystem(small_config(TConfig, weighted_first), device="cpu")
    lset = convert.lset_from_numpy(
        {k: v for k, v in js._cur_lset._asdict().items()})
    mlp = convert.mlp_from_numpy(jax.tree.map(np.asarray,
                                              js.params["geo_mlp"]))
    track = ts._track
    tres = track(torch.as_tensor(np.array(js._cur_track_feats)), mlp,
                 torch.as_tensor(src_pts), torch.as_tensor(mask),
                 torch.as_tensor(T_init, dtype=torch.float32),
                 torch.as_tensor(anchor, dtype=torch.float32), lset)
    assert int(tres.iterations) == int(jres.iterations)
    assert bool(tres.valid) == bool(jres.valid)
    assert int(tres.fail_code) == int(jres.fail_code)
    assert int(tres.valid_count) == int(jres.valid_count)
    Tj = np.asarray(jres.pose, np.float64)
    Tt = tres.pose.numpy().astype(np.float64)
    assert np.linalg.norm(Tt[:3, 3] - Tj[:3, 3]) <= 1e-4
    # relative rotation angle from its skew part (arccos of the trace is
    # blind below ~0.05 deg for float32 matrices that are not orthonormal)
    R = Tt[:3, :3].T @ Tj[:3, :3]
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    assert np.degrees(np.arcsin(min(np.linalg.norm(w) / 2, 1.0))) <= 1e-3
    # and the registration itself is sane against a map trained on one
    # frame only: within 5 cm / 0.2 deg of GT
    gt = seq.poses[1].copy()
    gt[:3, 3] -= anchor
    assert np.linalg.norm(Tt[:3, 3] - gt[:3, 3]) < 0.05
    assert np_rotation_angle_deg(Tt[:3, :3].T @ gt[:3, :3]) < 0.2
    assert isinstance(ts.qp, tmq.QueryParams)
