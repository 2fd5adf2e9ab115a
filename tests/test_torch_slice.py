"""The port's track+map slice (pin_slam_tpu_torch.slam.system) against the
JAX package's PinSLAMSystem in join mode, at a small size on the CPU.

* preprocess: the train and source clouds and their counts are equal;
* frame update: with the sampler's random draws handed to both sides, the
  map counts and the replay pool agree (float rounding of the sample
  transform may move a rare sample across a voxel boundary: counts within
  0.5 %, pool rows <= 1e-5);
* six synthetic frames: both systems start from the same decoder, but
  their random draws (ray samples, batches) come from different
  generators, so this comparison is STATISTICAL: each frame's pose within
  MAX_DT / MAX_DA (see below) of the other system and of ground truth, map
  point counts within 5 %.
"""

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
from pin_slam_tpu_torch.slam.system import PinSLAMSystem as TSystem

N_FRAMES = 6
# Pose bounds of the six-frame comparison. At this size (3 training
# iterations, 2k source points) the JAX reference's own error against
# ground truth ranges over 1-12 cm and 0.01-0.3 deg across random keys
# (measured with three keys per system, both systems alike), so a 2 cm bar
# would fail the reference itself; 10 cm / 0.5 deg holds for both.
MAX_DT, MAX_DA = 0.10, 0.5


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
    cfg.init_iter_ratio = 100
    cfg.bs_new_sample = 256
    cfg.reg_iter_n = 20
    cfg.map_capacity = 1 << 16
    cfg.buffer_size = 1 << 18
    cfg.frame_point_cap = 1 << 13
    cfg.source_point_cap = 1 << 11
    cfg.max_frames = 16
    cfg.local_set_cap = 1 << 16    # never truncates the local map here
    cfg.train_subset_hist = 2048
    cfg.probe_mode = "join"
    cfg.finalize()
    cfg.pool_capacity = 200_000
    return cfg



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: when six test workers share the cores, the
    systems' default thread pools oversubscribe them (this file's runs then
    took 0.8-1.0 ks)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def seq():
    s = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(N_FRAMES, radius=6.0, revolutions=0.03,
                                ease_in_frames=4),
        dirs=lidar_directions(512, 32), max_range=60.0)
    return s, [s.frame(i) for i in range(N_FRAMES)]


def _t(a):
    return torch.as_tensor(np.array(a))


def test_preprocess(seq):
    _, frames = seq
    js = JSystem(small_config(JConfig))
    ts = TSystem(small_config(TConfig), device="cpu")
    for f in frames[:2]:
        jp = [np.asarray(a) for a in js._run_preprocess(f, None)]
        tp = [a.numpy() for a in ts._run_preprocess(f)]
        # (train, attr, n, src, attr, n, total, total) on both sides
        assert len(tp) == len(jp) == 8
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a, b)


def test_frame_update(seq):
    s, frames = seq
    js = JSystem(small_config(JConfig))
    ts = TSystem(small_config(TConfig), device="cpu")
    pre = js._run_preprocess(frames[0], None)
    c = js.config
    T = np.asarray(s.poses[0], np.float32)
    td = np.zeros(c.max_frames, np.float32)
    key = jax.random.PRNGKey(11)
    jst, jpool, _, jratio, jobs = js._frame_update_init(
        js.state, js.pool, pre[0], pre[1], pre[2], jnp.asarray(T),
        jnp.int32(0), jnp.asarray(td), key, jnp.bool_(False),
        jnp.ones(c.frame_point_cap, bool), jnp.bool_(True))
    # the JAX sampler's draws, reproduced from its key schedule
    ks = jax.random.split(key)[1]
    k_s, k_f, k_b = jax.random.split(ks, 3)
    n = c.frame_point_cap
    noise = (_t(jax.random.normal(k_s, (n, c.surface_sample_n))),
             _t(jax.random.uniform(k_f, (n, c.free_front_n))),
             _t(jax.random.uniform(k_b, (n, c.free_behind_n))))
    tratio, tobs = ts.frame_update(
        _t(pre[0]), _t(pre[2]), _t(T), 0, _t(td), force_all_new=False,
        do_map=torch.tensor(True), insert_cap=1 << 16, noise=noise)
    jc, tc = int(jst.count), int(ts.state.count)
    assert jc > 1000 and abs(tc - jc) <= 0.005 * jc
    assert abs(float(tratio) - float(jratio)) < 0.01
    assert abs(float(tobs) - float(jobs)) < 0.01
    assert int(ts.pool.count) == int(jpool.count)
    assert int(ts.pool.write_pos) == int(jpool.write_pos)
    P = int(jpool.count)
    for f in ("coord", "sdf_label", "weight"):
        np.testing.assert_allclose(getattr(ts.pool, f)[:P].numpy(),
                                   np.asarray(getattr(jpool, f))[:P],
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    np.testing.assert_array_equal(ts.pool.ts[:P].numpy(),
                                  np.asarray(jpool.ts)[:P])
    jn, tn = int(jpool.new_count), int(ts.pool.new_count)
    assert abs(tn - jn) <= 0.005 * max(jn, 1)


@pytest.fixture(scope="module")
def runs(seq):
    s, frames = seq
    js = JSystem(small_config(JConfig))
    ts = TSystem(small_config(TConfig), device="cpu")
    # both systems start from the JAX system's initial decoder
    ts.params["geo_mlp"] = convert.mlp_from_numpy(
        jax.tree.map(np.asarray, js.params["geo_mlp"]), device="cpu")
    out = {"jax": [], "torch": [], "jcount": [], "tcount": []}
    for sys_, name, cnt in ((js, "jax", "jcount"), (ts, "torch", "tcount")):
        sys_.set_gt_poses(s.poses)
        for i in range(N_FRAMES):
            nxt = frames[i + 1] if i + 1 < N_FRAMES else None
            out[name].append(sys_.process_frame(i, frames[i],
                                                next_points=nxt))
            out[cnt].append(int(sys_.state.count))
    return s, out


def _err(a, b):
    dt = np.linalg.norm(a[:3, 3] - b[:3, 3])
    R = a[:3, :3].T @ b[:3, :3]
    da = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    return dt, da


@pytest.mark.parametrize("frame", range(1, N_FRAMES))
def test_six_frames_pose(runs, frame):
    s, out = runs
    for other in (out["jax"][frame], s.poses[frame]):
        dt, da = _err(out["torch"][frame], other)
        assert dt < MAX_DT and da < MAX_DA, (frame, dt, da)
    # the JAX reference meets the same ground-truth bound on this run
    dt, da = _err(out["jax"][frame], s.poses[frame])
    assert dt < MAX_DT and da < MAX_DA, ("jax", frame, dt, da)


def test_six_frames_map_counts(runs):
    _, out = runs
    for j, t in zip(out["jcount"], out["tcount"]):
        assert abs(t - j) <= 0.05 * j, (out["jcount"], out["tcount"])
